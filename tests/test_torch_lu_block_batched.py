"""The batched panel elimination (K2 over a batch of blocks) and the batched
panel family built on it, against the JAX package on the CPU.

The JAX side runs its Pallas kernel in interpret mode, one block at a time
(as the JAX package itself runs its tournament chunks); the port runs its
kernel's plain version over the whole batch. Inputs are made from a seed
with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conflux_tpu.ops import blas as jblas
from conflux_tpu.ops import pallas_kernels
from conflux_tpu.validation import make_test_matrix
from conflux_tpu_torch.ops import blas as tblas
from conflux_tpu_torch.ops import hopper_kernels

W = hopper_kernels._PANEL_W


@pytest.fixture
def shrunk_kernel_rows():
    # panels taller than 256 rows go through the tournament, with 256-row
    # chunks and (2v, v) tree rounds on the kernel in both packages
    old = (jblas._PALLAS_MAX_ROWS, tblas._PALLAS_MAX_ROWS)
    jblas._PALLAS_MAX_ROWS = tblas._PALLAS_MAX_ROWS = 256
    yield
    jblas._PALLAS_MAX_ROWS, tblas._PALLAS_MAX_ROWS = old


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("m", [256, 300])
@pytest.mark.parametrize("dead", [0.0, 0.25])
def test_lu_block_plain_batched_matches_pallas_per_slot(B, m, dead):
    rng = np.random.default_rng(B * 1000 + m + int(dead * 100))
    a = rng.standard_normal((B, m, W)).astype(np.float32)
    alive = (rng.random((B, m, 1)) >= dead).astype(np.int32)
    out, al, piv = hopper_kernels.lu_block(torch.from_numpy(a), torch.from_numpy(alive))
    assert out.shape == (B, m, W) and al.shape == (B, m, 1) and piv.shape == (B, 1, W)
    for i in range(B):
        out_j, al_j, piv_j = pallas_kernels.lu_block(jnp.asarray(a[i]),
                                                     jnp.asarray(alive[i].astype(np.int8)))
        np.testing.assert_array_equal(piv[i].numpy(), np.asarray(piv_j))
        np.testing.assert_array_equal(al[i].numpy(), np.asarray(al_j))
        # the same division and one FMA per update: bit for bit but for
        # the plain version's double-rounding ties
        np.testing.assert_allclose(out[i].numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)


def test_lu_block_batched_slot_equals_single_call():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((3, 200, W)).astype(np.float32))
    alive = torch.from_numpy((rng.random((3, 200)) >= 0.2).astype(np.int32))
    out, al, piv = hopper_kernels.lu_block(a, alive)
    for i in range(3):
        o1, a1, p1 = hopper_kernels.lu_block(a[i], alive[i])
        assert torch.equal(out[i], o1) and torch.equal(al[i], a1) and torch.equal(piv[i], p1)


def test_lu_block_batched_rejects_mismatched_alive():
    with pytest.raises(ValueError):
        hopper_kernels.lu_block(torch.zeros((2, 8, W)), torch.ones((3, 8, 1)))


@pytest.mark.parametrize("B,m,v", [(3, 256, 128), (2, 384, 256)])
def test_panel_lu_batched_matches_jax_per_slot(B, m, v):
    panels = np.stack([make_test_matrix(m, v, seed=31 + i) for i in range(B)]).astype(np.float32)
    lu_t, perm_t = tblas.panel_lu_pallas_batched(torch.from_numpy(panels))
    assert lu_t.shape == (B, m, v) and perm_t.shape == (B, m)
    for i in range(B):
        lu_j, perm_j = jblas.panel_lu_pallas(jnp.asarray(panels[i]))
        np.testing.assert_array_equal(perm_t[i].numpy(), np.asarray(perm_j))
        # the inter-block products sum in another order than XLA's: the U
        # rows reach ~20, so the bound is relative as well as absolute
        np.testing.assert_allclose(lu_t[i].numpy(), np.asarray(lu_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nch", [2, 3, 5])
def test_tournament_winners_matches_jax(shrunk_kernel_rows, nch):
    # nch = 3 and 5 pad the tree with zero blocks of out-of-range ids
    panel = make_test_matrix(256 * nch, W, seed=40 + nch).astype(np.float32)
    lu_j, gpiv_j = jblas.tournament_winners(jnp.asarray(panel), chunk=256, use_pallas=True)
    lu_t, gpiv_t = tblas.tournament_winners(torch.from_numpy(panel), chunk=256)
    np.testing.assert_array_equal(gpiv_t.numpy(), np.asarray(gpiv_j))
    np.testing.assert_allclose(lu_t.numpy(), np.asarray(lu_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nch,v", [(2, 128), (3, 128), (5, 128), (4, 256)])
def test_tournament_makes_one_batched_call_per_round(monkeypatch, nch, v):
    c = 256 if v == 128 else 512  # chunks of the kernel's (shrunk) height
    monkeypatch.setattr(tblas, "_PALLAS_MAX_ROWS", c)
    calls = []
    kernel = hopper_kernels.lu_block

    def counted(a, alive):
        calls.append(tuple(a.shape))
        return kernel(a, alive)

    monkeypatch.setattr(hopper_kernels, "lu_block", counted)
    panel = make_test_matrix(c * nch, v, seed=nch).astype(np.float32)
    tblas.tournament_winners(torch.from_numpy(panel), chunk=c)
    n = 1 << (nch - 1).bit_length()
    rounds = 1 + n.bit_length() - 1  # the chunks, then log2 n tree levels
    assert len(calls) == rounds * (v // W)
    # the chunk round factors every chunk at once, each tree level all its pairs
    sizes = [s[0] for s in calls[::v // W]]
    assert sizes == [nch] + [n >> k for k in range(1, n.bit_length())]
    assert tblas.lu_block_launches(c * nch, v) == len(calls)


def test_lu_block_launches_at_the_main_path():
    # N=32768 v=1024: 800 K2 launches per factorization (2272 one chunk at
    # a time): 8 column blocks times the batched factorizations of the 32
    # supersteps' panels
    total = sum(tblas.lu_block_launches(32768 - 1024 * k, 1024) for k in range(32))
    assert total == 800


# what an H100 80GB HBM3 holds of K2 at once (its occupancy API, read on
# the card): CTAs of the grid route, clusters of 1..16 CTAs
_H100 = {0: 132, 1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9,
         **{cs: 7 for cs in range(10, 17)}}


@pytest.mark.parametrize("B,m,want", [
    (1, 256, (1, 0)),      # one CTA: a cluster of one
    (2, 2048, (8, 0)),     # the tree rounds of the N=32768 cell
    (1, 2048, (8, 0)),
    (1, 2304, (9, 0)),     # a non-portable cluster
    (1, 4096, (16, 0)),
    (12, 4096, (16, 0)),   # two waves of clusters against two grid launches: the clusters
    (8, 4096, (0, 8)),     # two waves of clusters against one grid launch
    (16, 2048, (0, 16)),   # 15 clusters of 8 at once: two waves against one launch
    (4, 8192, (0, 4)),     # the cell's chunks: 32 CTAs a block
    (1, 4352, (0, 7)),     # 17 CTAs: past the largest cluster
    (1, 33792, (0, 1)),    # the tallest block the card holds
])
def test_plan_lu_block_routes(B, m, want):
    assert tuple(hopper_kernels.plan_lu_block(m, B, _H100.get)) == want


def test_plan_lu_block_without_large_clusters():
    # a card that takes no cluster of 16 sends a 4096-row block to the grid;
    # a block of more CTAs than it holds raises
    card = {**_H100, 16: 0}
    assert tuple(hopper_kernels.plan_lu_block(4096, 1, card.get)) == (0, 8)
    with pytest.raises(ValueError, match="more CTAs than the card holds"):
        hopper_kernels.plan_lu_block(33793, 1, _H100.get)
