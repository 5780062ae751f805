"""The port's QR family on the CPU (`conflux_tpu_torch.qr`: `tall_qr`,
`qr_factor_blocked`, `cholesky_qr2`; `solvers.lstsq`;
`validation.qr_residual_device`; the 1x1x1 routes of the `qr_miniapp`
CLI), against the JAX package's functions on the same seeded numpy inputs
(the shapes of tests/test_qr.py).

R's positive diagonal makes a full-rank thin QR unique, so parity is
allclose on both factors: float64 within 1e-10 of max |R| (tests/test_qr.py's
bar against numpy), float32 rtol 1e-5 / atol 1e-5 after scaling by max |R|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu import solvers as jsolvers
from conflux_tpu.geometry import Grid3
from conflux_tpu.parallel.mesh import make_mesh
from conflux_tpu.qr import cholesky_qr2_distributed, qr_factor_blocked as jqr_blocked
from conflux_tpu.qr import tall_qr as jtall_qr
from conflux_tpu_torch import solvers as tsolvers
from conflux_tpu_torch.cli import qr_miniapp
from conflux_tpu_torch.qr import cholesky_qr2, qr_factor_blocked, tall_qr
from conflux_tpu_torch.validation import qr_residual_device, residual_bound


def _orth_err(Q):
    Q = np.asarray(Q, np.complex128 if np.iscomplexobj(Q) else np.float64)
    n = Q.shape[1]
    return np.linalg.norm(Q.conj().T @ Q - np.eye(n)) / np.sqrt(n)


def _check(A, Q, R, eps_mult=50):
    """tests/test_qr.py's oracle: triangular R with a real non-negative
    diagonal, eps-grade orthogonality and reconstruction."""
    Q, R = np.asarray(Q), np.asarray(R)
    n = A.shape[1]
    eps = np.finfo(np.float32 if Q.dtype in (np.float32, np.complex64) else np.float64).eps
    assert np.allclose(np.tril(R, -1), 0.0)
    d = np.diag(R)
    assert (d.real >= 0).all() and np.allclose(d.imag, 0.0)
    assert _orth_err(Q) < eps_mult * eps
    rec = np.linalg.norm(Q.astype(np.complex128) @ R - A) / np.linalg.norm(A)
    assert rec < eps_mult * eps * np.sqrt(n)


def _close(t, j, dtype):
    j = np.asarray(j)
    scale = np.abs(j).max()
    if dtype in (np.float64, np.complex128):
        np.testing.assert_allclose(np.asarray(t), j, atol=1e-10 * scale)
    else:
        np.testing.assert_allclose(np.asarray(t) / scale, j / scale, rtol=1e-5, atol=1e-5)


def _gen(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.standard_normal(shape)
    return A.astype(dtype)


@pytest.mark.parametrize("shape,dtype", [((96, 96), np.float64), ((192, 64), np.float64),
                                         ((64, 50), np.float64), ((128, 32), np.float32),
                                         ((80, 40), np.complex128)])
def test_qr_factor_blocked_matches_jax(shape, dtype):
    A = _gen(shape, 3, dtype)
    Q, R = qr_factor_blocked(torch.from_numpy(A), v=16)
    jQ, jR = jqr_blocked(jnp.asarray(A), v=16)
    assert Q.dtype == torch.from_numpy(A).dtype and tuple(R.shape) == (shape[1],) * 2
    _check(A, Q.numpy(), R.numpy(), eps_mult=100 if dtype == np.float32 else 50)
    _close(R.numpy(), jR, dtype)
    _close(Q.numpy(), jQ, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_qr_factor_blocked_reproject_keeps_orthogonality(dtype):
    """`reproject=True` (the miniapp's --full): the same unique factors,
    and float32 orthogonality at eps scale where one sweep loses it."""
    A = _gen((256, 256), 5, dtype)
    Q1, R1 = qr_factor_blocked(torch.from_numpy(A), v=32)
    Q2, R2 = qr_factor_blocked(torch.from_numpy(A), v=32, reproject=True)
    _check(A.astype(np.float64), Q2.numpy(), R2.numpy(), eps_mult=100)
    assert _orth_err(Q2.numpy()) <= _orth_err(Q1.numpy())
    jR = jqr_blocked(jnp.asarray(A), v=32)[1]
    if dtype == np.float64:
        _close(R2.numpy(), jR, dtype)


def test_tall_qr_chunked_tree_and_ill_conditioned_match_jax():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((640, 24))
    Q1, R1 = tall_qr(torch.from_numpy(A), chunk=64)   # 10 chunks, 2 levels
    Q2, R2 = tall_qr(torch.from_numpy(A), chunk=4096)
    _check(A, Q1.numpy(), R1.numpy())
    _close(R1.numpy(), R2.numpy(), np.float64)
    _close(R1.numpy(), jtall_qr(jnp.asarray(A), chunk=64)[1], np.float64)
    rng = np.random.default_rng(7)
    U, _ = np.linalg.qr(rng.standard_normal((256, 24)))
    Vt, _ = np.linalg.qr(rng.standard_normal((24, 24)))
    Ab = (U * np.logspace(0, -8, 24)) @ Vt.T
    Q, R = tall_qr(torch.from_numpy(Ab), chunk=64)
    _check(Ab, Q.numpy(), R.numpy(), eps_mult=200)
    jQ, jR = jtall_qr(jnp.asarray(Ab), chunk=64)
    _close(R.numpy(), jR, np.float64)
    # bfloat16 panels compute in float32 and come back in bfloat16
    Qb, Rb = tall_qr(torch.from_numpy(A.astype(np.float32)).bfloat16())
    assert Qb.dtype == Rb.dtype == torch.bfloat16


def test_qr_rejects_wide():
    for f in (qr_factor_blocked, tall_qr, cholesky_qr2):
        with pytest.raises(ValueError):
            f(torch.zeros((8, 16)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cholesky_qr2_matches_jax_on_one_device(dtype):
    """`cholesky_qr2` is the body of the JAX `cholesky_qr2_distributed` at
    Px=1: the same factors on a one-device mesh."""
    A = _gen((128, 16), 17, dtype)
    Q, R = cholesky_qr2(torch.from_numpy(A))
    mesh = make_mesh(Grid3(1, 1, 1), devices=jax.devices()[:1])
    jQ, jR = cholesky_qr2_distributed(A[None], mesh)
    _check(A.astype(np.float64), Q.numpy(), R.numpy(), eps_mult=100)
    _close(R.numpy(), jR, dtype)
    _close(Q.numpy(), np.asarray(jQ)[0], dtype)


def test_lstsq_matches_jax():
    rng = np.random.default_rng(21)
    A = rng.standard_normal((300, 40))
    b = rng.standard_normal((300, 2))
    xt = tsolvers.lstsq(torch.from_numpy(A), torch.from_numpy(b))
    xj = jsolvers.lstsq(jnp.asarray(A), jnp.asarray(b))
    ref = np.linalg.lstsq(A, b, rcond=None)[0]
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(xt.numpy(), ref, rtol=1e-10, atol=1e-10)
    x1 = tsolvers.lstsq(torch.from_numpy(A), torch.from_numpy(b[:, 0]))
    assert tuple(x1.shape) == (40,)
    with pytest.raises(ValueError, match="rows"):
        tsolvers.lstsq(torch.from_numpy(A), torch.from_numpy(b[:10]))
    # bf16 factors (QR computed in f32) + refinement in f32, a consistent system
    A32 = A.astype(np.float32)
    xs = rng.standard_normal(40).astype(np.float32)
    b32 = A32 @ xs
    xr = tsolvers.lstsq(torch.from_numpy(A32), torch.from_numpy(b32),
                        factor_dtype=torch.bfloat16, refine=2)
    xjr = jsolvers.lstsq(jnp.asarray(A32), jnp.asarray(b32), factor_dtype=jnp.bfloat16,
                         refine=2)
    assert xr.dtype == torch.float32
    assert np.abs(xr.numpy() - xs).max() < 1e-3 and np.abs(np.asarray(xjr) - xs).max() < 1e-3


def test_qr_residual_device_matches_host():
    rng = np.random.default_rng(23)
    A = rng.standard_normal((200, 72)).astype(np.float32)
    Q, R = qr_factor_blocked(torch.from_numpy(A), v=16)
    rec, orth = qr_residual_device(torch.from_numpy(A), Q, R, strip=32)
    Qn, Rn = Q.numpy().astype(np.float64), R.numpy().astype(np.float64)
    assert rec == pytest.approx(np.linalg.norm(Qn @ Rn - A) / np.linalg.norm(A), rel=1e-9)
    assert orth == pytest.approx(_orth_err(Qn), rel=1e-9)
    Ac = _gen((60, 20), 24, np.complex128)
    Qc, Rc = qr_factor_blocked(torch.from_numpy(Ac), v=8)
    rec_c, orth_c = qr_residual_device(torch.from_numpy(Ac), Qc, Rc, strip=16)
    assert rec_c < 1e-14 and orth_c < 1e-14


@pytest.mark.parametrize("argv,algo,n_field,tile", [
    (["-M", "512", "--cols", "64"], "qr-tsqr", 512, 64),
    (["-M", "512", "--cols", "64", "--algo", "cholesky"], "qr-cholesky", 512, 64),
    (["-M", "256", "--cols", "256", "--full", "-b", "64"], "qr", 256, 64),
    (["-M", "256", "--cols", "200", "--full", "-b", "64", "--tree", "gather"], "qr", 256, 64),
])
def test_qr_miniapp_one_device_routes(capsys, argv, algo, n_field, tile):
    assert qr_miniapp.main(["--platform", "cpu", "-r", "1", "--validate", *argv]) == 0
    out = capsys.readouterr().out.splitlines()
    res = [l for l in out if l.startswith("_result_ ")]
    assert len(res) == 1
    f = res[0].split()[1].split(",")
    assert f[0] == algo and f[1] == "conflux_tpu_torch" and int(f[2]) == n_field
    assert f[4] == "1" and f[5] == "1x1x1" and int(f[9]) == tile and f[10] == "float32"
    (resid,) = [l for l in out if l.startswith("_residual_ ")]
    orth = float(resid.split("orth=")[1].split()[0])
    rec = float(resid.split("reconstruction=")[1])
    bound = residual_bound(n_field if "--full" in argv else tile, np.float32)
    assert orth <= bound and rec <= bound


# the first five routes exited "not ported yet" until the distributed QR
# route came; they run now, under their old ids
@pytest.mark.parametrize("argv,msg", [
    (["--p_grid", "2,1,1"], None), (["--tree", "butterfly"], None),
    (["--full", "--lookahead", "-M", "64", "--cols", "64"], None),
    (["--csegs", "4"], None), (["--auto"], None),
    (["-M", "8", "--cols", "16"], "M >= n"), (["--lookahead"], "--full"),
], ids=[f"argv{i}-{m}" for i, m in enumerate(["not ported yet"] * 5 + ["M >= n", "--full"])])
def test_qr_miniapp_exits_naming_the_route(argv, msg):
    """The five routes of the distributed program run (exit code 0); the
    two real refusals, M < n and --lookahead without --full, exit naming
    the rule."""
    if msg is None:
        prev = torch.get_num_threads()
        torch.set_num_threads(1)  # beside other pytest workers: no oversubscription
        try:
            assert qr_miniapp.main(["--platform", "cpu", "-r", "0", *argv]) == 0
        finally:
            torch.set_num_threads(prev)
        return
    with pytest.raises(SystemExit, match=msg):
        qr_miniapp.main(["--platform", "cpu", "-r", "0", *argv])
