"""Parity of the port's kernel functions (`conflux_tpu_torch.ops.hopper_kernels`)
with the JAX package's Pallas kernels (`conflux_tpu.ops.pallas_kernels`, run
in interpret mode on the CPU). On a CPU tensor the port's wrappers run their
plain PyTorch versions, so these tests hold the plain versions to the JAX
functions; the kernels themselves are held to the plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu.ops import pallas_kernels
from conflux_tpu_torch.ops import hopper_kernels


@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 128, 384), (100, 60, 130)])
def test_gemm_plain_matches_pallas_f32(shape):
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    want = np.asarray(pallas_kernels.gemm(jnp.asarray(a), jnp.asarray(b)))
    got = hopper_kernels.gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    # f32 accumulation in another order: atol as tests/test_ops.py
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_gemm_plain_matches_pallas_bf16():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((128, 256)).astype(np.float32)
    b = rng.standard_normal((256, 128)).astype(np.float32)
    want = np.asarray(pallas_kernels.gemm(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    ).astype(jnp.float32))
    got = hopper_kernels.gemm(torch.from_numpy(a).bfloat16(),
                              torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    # both accumulate in f32 and round once to bf16: at most one bf16 ulp
    # (2^-8 relative) apart where the f32 sums straddle a rounding boundary
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=1e-2)


def test_gemm_epilogue_and_in_place_out():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((32, 48)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    want = -1.0 * (a @ b) + 0.5 * c
    hopper_kernels.gemm(a, b, c=c, alpha=-1.0, beta=0.5, out=c)
    np.testing.assert_allclose(c.numpy(), want.numpy(), atol=1e-5)


def test_gemm_rejects_float64():
    x = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        hopper_kernels.gemm(x, x)


@pytest.mark.parametrize("dead_frac", [0.0, 0.3])
def test_lu_block_plain_matches_pallas(dead_frac):
    m, w = 192, hopper_kernels._PANEL_W
    rng = np.random.default_rng(int(dead_frac * 10) + 1)
    a = rng.standard_normal((m, w)).astype(np.float32)
    alive = (rng.random((m, 1)) >= dead_frac).astype(np.int8)
    out_j, alive_j, piv_j = pallas_kernels.lu_block(jnp.asarray(a), jnp.asarray(alive))
    out_t, alive_t, piv_t = hopper_kernels.lu_block(torch.from_numpy(a),
                                                    torch.from_numpy(alive))
    np.testing.assert_array_equal(piv_t.numpy(), np.asarray(piv_j))
    np.testing.assert_array_equal(alive_t.numpy(), np.asarray(alive_j))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)


def test_lu_block_rejects_bad_width():
    with pytest.raises(ValueError):
        hopper_kernels.lu_block(torch.zeros((8, 64)), torch.ones((8, 1)))
