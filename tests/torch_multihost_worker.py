"""Worker of the port's multi-process tests (`test_torch_mesh.py`): one rank
of a CPU world brought up by `initialize_multihost` from the environment
torchrun would set (env://: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK),
gloo collectives between the processes. Each rank builds only its own
shard, from a position formula (the reference's per-rank `InitMatrix`
role), factors on the grid and validates there, with no global matrix
anywhere.

    python torch_multihost_worker.py lu GRID ELECTION
    python torch_multihost_worker.py chol GRID
    python torch_multihost_worker.py survive|die
    python torch_multihost_worker.py resume PHASE CKPT_DIR
    python torch_multihost_worker.py qr
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, LUGeometry  # noqa: E402
from conflux_tpu_torch.parallel.mesh import (  # noqa: E402
    distribute_shards,
    initialize_multihost,
    make_mesh,
)

mode = sys.argv[1]
rank = int(os.environ["RANK"])
calls = []


def pos_fill(geom, grid, px, py):
    """Rank (px, py)'s (Ml, Nl) shard straight from global indices."""
    calls.append((px, py))
    v = geom.v
    li, lj = np.arange(geom.Ml), np.arange(geom.Nl)
    gi = ((li // v) * grid.Px + px) * v + li % v
    gj = ((lj // v) * grid.Py + py) * v + lj % v
    G = np.sin(0.37 * gi[:, None] + 1.31 * gj[None, :]).astype(np.float32)
    return G + geom.M * (gi[:, None] == gj[None, :])


initialize_multihost(backend="gloo")

if mode in ("lu", "chol"):
    grid = Grid3.parse(sys.argv[2])
    mesh = make_mesh(grid, device="cpu", timeout=120.0)
    v = 8
    if mode == "lu":
        from conflux_tpu_torch.lu.distributed import lu_factor_distributed
        from conflux_tpu_torch.validation import lu_residual_distributed

        geom = LUGeometry.create(8 * v, 8 * v, v, grid)
        shard = distribute_shards(lambda px, py: pos_fill(geom, grid, px, py), mesh,
                                  shape=(grid.Px, grid.Py, geom.Ml, geom.Nl),
                                  dtype=np.float32)
        out, perm = lu_factor_distributed(shard, geom, mesh, election=sys.argv[3],
                                          panel_algo="auto")
        res = lu_residual_distributed(shard, out, perm, geom, mesh)
    else:
        from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed
        from conflux_tpu_torch.io import generate_spd_local
        from conflux_tpu_torch.validation import cholesky_residual_distributed

        geom = CholeskyGeometry.create(8 * v, v, grid)

        def fill(px, py):
            calls.append((px, py))
            return generate_spd_local(geom, px, py, dtype=np.float32)

        shard = distribute_shards(fill, mesh, shape=(grid.Px, grid.Py, geom.Ml, geom.Nl),
                                  dtype=np.float32)
        out = cholesky_factor_distributed(shard, geom, mesh)
        res = cholesky_residual_distributed(shard, out, geom, mesh)
    print(f"rank {rank}: coords={mesh.coords} calls={calls} residual={res:.3e}", flush=True)
    assert calls == [(mesh.x, mesh.y)], calls  # only this rank's shard was built
    assert res < 1e-4, res
elif mode in ("survive", "die"):
    mesh = make_mesh(Grid3(2, 1, 1), device="cpu", timeout=10.0)
    import torch

    t = torch.ones(4)
    mesh.psum(t, "x")
    if mode == "die":
        os._exit(17)  # a lost rank, mid-run
    t0 = time.time()
    try:
        mesh.psum(t, "x")  # the peer is gone: must fail, not hang
    except Exception as e:  # noqa: BLE001 (any transport error is the detection)
        print(f"rank {rank}: peer loss detected in {time.time() - t0:.1f} s: "
              f"{type(e).__name__}", flush=True)
        os._exit(0)
    print(f"rank {rank}: the collective returned without its peer", flush=True)
    os._exit(3)
elif mode == "resume":
    import torch

    from conflux_tpu_torch.io import load_matrix, save_matrix
    from conflux_tpu_torch.lu.distributed import lu_factor_steps
    from conflux_tpu_torch.validation import lu_residual_distributed

    phase, ckpt = int(sys.argv[2]), sys.argv[3]
    grid = Grid3(2, 1, 1)
    mesh = make_mesh(grid, device="cpu", timeout=120.0)
    v = 8
    geom = LUGeometry.create(8 * v, 8 * v, v, grid)
    half = geom.n_steps // 2
    shard = distribute_shards(lambda px, py: pos_fill(geom, grid, px, py), mesh,
                              shape=(grid.Px, grid.Py, geom.Ml, geom.Nl), dtype=np.float32)
    path = os.path.join(ckpt, f"{{}}_{mesh.x}_{mesh.y}.bin")
    if phase == 1:
        s, o, _ = lu_factor_steps(shard, geom, mesh, 0, half, panel_algo="auto")
        save_matrix(path.format("shard"), s.numpy())  # each rank its own shard
        save_matrix(path.format("orig"), o.numpy().astype(np.int32)[None])
        print(f"rank {rank}: phase1 checkpointed", flush=True)
    else:
        s = torch.from_numpy(load_matrix(path.format("shard")))
        o = torch.from_numpy(load_matrix(path.format("orig"))[0].astype(np.int64))
        out, _, perm = lu_factor_steps(s, geom, mesh, half, geom.n_steps, orig=o,
                                       panel_algo="auto")
        res = lu_residual_distributed(shard, out, perm, geom, mesh)
        print(f"rank {rank}: phase2 residual={res:.3e}", flush=True)
        assert res < 1e-4, res
elif mode == "qr":
    import torch

    from conflux_tpu_torch.qr.distributed import tsqr_distributed

    Px, Ml, n = 2, 32, 12
    mesh = make_mesh(Grid3(Px, 1, 1), device="cpu", timeout=120.0)

    def local_rows(px):
        # a deterministic tall block from global row indices: no rank ever
        # holds the (M, n) matrix
        gi = px * Ml + np.arange(Ml)
        blk = np.cos(0.23 * gi[:, None] + 0.71 * np.arange(n)[None, :]).astype(np.float32)
        return blk + (gi[:, None] == np.arange(n)[None, :])

    a = torch.from_numpy(local_rows(mesh.x))
    Q, R = tsqr_distributed(a, mesh)
    rec = float((Q @ R - a).abs().max())
    gram = mesh.psum((Q.mT @ Q).contiguous(), "x")
    orth = float((gram - torch.eye(n)).abs().max())
    print(f"rank {rank}: qr rec={rec:.3e} orth={orth:.3e}", flush=True)
    assert rec < 1e-5 and orth < 1e-5, (rec, orth)
else:
    raise SystemExit(f"unknown mode {mode!r}")

import torch.distributed as dist  # noqa: E402

dist.destroy_process_group()
