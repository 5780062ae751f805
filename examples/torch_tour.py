"""End-to-end tour of the PyTorch/CUDA port, `conflux_tpu_torch`: every
major capability in one run, the port's counterpart of `examples/tour.py`.

The JAX tour runs on a simulated 8-device CPU mesh. This one runs a world of
8 ranks as threads of this process (`parallel.mesh.run_threaded`): on the
card they share it over the "staged" transport, on the CPU (`--platform
cpu`) they talk over gloo. The steps:

  1. distributed LU with tournament pivoting on a 2x2x2 (2.5D) grid
  2. gather-free on-grid validation (the pdgemm role)
  3. direct solves, bfloat16 factors with iterative refinement, GMRES-IR
  4. distributed Cholesky and its on-grid residual, Hermitian input too
  5. checkpoint mid-factorization to disk, restart, finish
  6. block-cyclic redistribution between layouts (the COSTA role) and
     ScaLAPACK local-buffer export of the computed factors
  7. tall-skinny QR (TSQR tree and CholeskyQR2), the full block-cyclic QR
     and least squares through it
  8. an odd 3x2x1 grid with the butterfly election, and the measured
     dispatch table

Run:  python examples/torch_tour.py [--platform cpu]

Every step checks the bars the JAX tour asserts and raises if one is
missed. The panels are 16 and 64 wide, below the 128 the K2 panel kernel
takes, so the grid LUs elect on the library LU ("auto"); the float32
trailing updates run K1, and step 3's bfloat16 solve (v=256) runs K1 and
K2.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

AXES = ("x", "y", "z")


def step(msg: str) -> None:
    print(f"\n== {msg}", flush=True)


def bar(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(f"tour: {msg}")


def _barrier(mesh) -> None:
    mesh.psum(torch.zeros(1, device=mesh.device), AXES)


def _grid_steps(mesh, N: int, v: int, tmp: str, world) -> dict:
    """Steps 1-7 on the 2x2x2 world, every rank together; rank 0 prints
    and runs the host-side parts (the other ranks wait at their next
    collective). Returns rank 0's readings."""
    from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed
    from conflux_tpu_torch.geometry import CholeskyGeometry, LUGeometry
    from conflux_tpu_torch.io import load_matrix, save_matrix
    from conflux_tpu_torch.layout import (
        BlockCyclicLayout,
        from_scalapack,
        gather,
        scalapack_desc,
        scatter,
        to_scalapack,
        transform,
    )
    from conflux_tpu_torch.lu.distributed import lu_factor_distributed, lu_factor_steps
    from conflux_tpu_torch.parallel.mesh import distribute_shards, gather_shards
    from conflux_tpu_torch.qr import qr_blocked_distributed_host, qr_distributed_host
    from conflux_tpu_torch.qr.distributed import qr_factor_distributed
    from conflux_tpu_torch.solvers import (
        lstsq,
        lu_solve_distributed,
        qr_lstsq_distributed,
        solve,
        solve_distributed,
    )
    from conflux_tpu_torch.validation import (
        cholesky_residual_distributed,
        lu_residual,
        lu_residual_distributed,
        make_hpd_matrix,
        make_spd_matrix,
        make_test_matrix,
    )

    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    grid, dev = mesh.grid, mesh.device
    out: dict = {}

    def gathered(shard, g) -> np.ndarray:
        return g.gather(gather_shards(shard, mesh).cpu().numpy())

    # ---- 1. distributed LU on the 2.5D grid -------------------------- #
    if lead:
        step(f"distributed LU: N={N}, v={v}, grid={grid} (2.5D z-replication)")
    geom = LUGeometry.create(N, N, v, grid)
    A = make_test_matrix(geom.M, geom.N, dtype=np.float32)
    S = geom.scatter(A)
    shard = distribute_shards(S, mesh)
    LU, perm = lu_factor_distributed(shard, geom, mesh, panel_algo="auto")
    out["perm"] = perm.cpu().numpy()
    say(f"factored: {geom.n_steps} supersteps, perm[:8]={out['perm'][:8]}")

    # ---- 2. gather-free validation ----------------------------------- #
    if lead:
        step("on-grid validation (nothing (N, N)-sized leaves the grid)")
    res = lu_residual_distributed(shard, LU, perm, geom, mesh)
    say(f"||A[perm] - L U||_F / ||A||_F = {res:.3e}")
    out["lu_residual"] = res
    bar(res < 1e-5, f"LU residual {res:.3e}")

    # ---- 3. solve + iterative refinement ----------------------------- #
    if lead:
        step("solve A x = b on the grid, then bf16 factors + IR to f32 grade")
    b = np.arange(geom.N, dtype=np.float32) / geom.N
    x = lu_solve_distributed(LU, perm, geom, mesh, torch.from_numpy(b)).cpu().numpy()
    B3 = np.stack([b, b * 2, b - 1], axis=1)  # several right-hand sides (getrs)
    X3 = lu_solve_distributed(LU, perm, geom, mesh, torch.from_numpy(B3)).cpu().numpy()
    nb = np.linalg.norm(b)
    out["solve_residual"] = float(np.linalg.norm(A @ x - b) / nb)
    out["multi_rhs_residual"] = float(np.linalg.norm(A @ X3 - B3) / np.linalg.norm(B3))
    say(f"direct solve residual ||Ax-b||/||b|| = {out['solve_residual']:.3e}")
    say(f"multi-RHS (N, 3) residual = {out['multi_rhs_residual']:.3e}")
    if lead:
        # the HPL-MxP trade needs cond(A) eps_bf16 < 1: a well-conditioned
        # system shows bf16 factors + IR reaching f32 grade
        W = make_test_matrix(geom.N, geom.N, dtype=np.float32)
        W = W + 3 * geom.N * np.eye(geom.N, dtype=np.float32)
        Wt, bt = torch.from_numpy(W).to(dev), torch.from_numpy(b).to(dev)
        x_bf = solve(Wt, bt, factor_dtype=torch.bfloat16, refine=0).cpu().numpy()
        x_ir = solve(Wt, bt, factor_dtype=torch.bfloat16, refine=3).cpu().numpy()
        r_bf = np.linalg.norm(W @ x_bf.astype(np.float64) - b) / nb
        r_ir = np.linalg.norm(W @ x_ir.astype(np.float64) - b) / nb
        out["bf16_residual"], out["bf16_ir_residual"] = float(r_bf), float(r_ir)
        print(f"bf16 factors, no refinement: {r_bf:.3e}")
        print(f"bf16 factors + 3 IR sweeps:  {r_ir:.3e} (f32 grade)")
        bar(r_ir < r_bf / 10, f"IR {r_ir:.3e} not 10x below {r_bf:.3e}")
    # where classic IR stalls (weak factors), GMRES-IR preconditioned by the
    # same factors converges; the port's residuals are float64
    x_g = solve_distributed(torch.from_numpy(A), torch.from_numpy(b), grid=grid, v=v,
                            mesh=mesh, factor_dtype=torch.bfloat16, ir="gmres", tol=1e-4,
                            panel_algo="auto")
    r_g = float(np.linalg.norm(A @ x_g.cpu().numpy() - b) / nb)
    out["gmres_residual"] = r_g
    say(f"bf16 factors + GMRES-IR (no diagonal boost): {r_g:.3e}")
    bar(r_g < 5e-4, f"GMRES-IR residual {r_g:.3e}")

    # ---- 4. distributed Cholesky -------------------------------------- #
    if lead:
        step("distributed Cholesky + on-grid residual")
    cgeom = CholeskyGeometry.create(N, v, grid)
    Sp = make_spd_matrix(cgeom.N, dtype=np.float32).numpy()
    sshard = distribute_shards(cgeom.scatter(Sp), mesh)
    Ls = cholesky_factor_distributed(sshard, cgeom, mesh)
    cres = cholesky_residual_distributed(sshard, Ls, cgeom, mesh)
    out["cholesky_residual"] = cres
    say(f"||A - L L^T||_F / ||A||_F = {cres:.3e}")
    bar(cres < 1e-5, f"Cholesky residual {cres:.3e}")
    # the same program factors Hermitian complex input (A = L L^H), on the
    # library products (K1 takes float32 and bfloat16)
    H = make_hpd_matrix(cgeom.N, dtype=np.complex64).numpy()
    hshard = distribute_shards(cgeom.scatter(H), mesh)
    Lh = cholesky_factor_distributed(hshard, cgeom, mesh, backend="xla")
    hres = cholesky_residual_distributed(hshard, Lh, cgeom, mesh)
    out["hermitian_residual"] = hres
    say(f"hermitian: ||A - L L^H||_F / ||A||_F = {hres:.3e}")
    bar(hres < 1e-5, f"Hermitian Cholesky residual {hres:.3e}")

    # ---- 5. checkpoint / restart -------------------------------------- #
    if lead:
        step("checkpoint mid-factorization to disk, restart, finish")
    half = geom.n_steps // 2
    s1, o1, _ = lu_factor_steps(distribute_shards(S, mesh), geom, mesh, 0, half,
                                panel_algo="auto")
    s1_host = gathered(s1, geom)
    o1_all = mesh.all_gather(o1, "x").cpu().numpy()  # (Px, Ml) row origins
    if lead:
        save_matrix(f"{tmp}/ckpt_A.bin", s1_host)
        save_matrix(f"{tmp}/ckpt_orig.bin", o1_all.astype(np.float32))
        print(f"checkpointed after {half}/{geom.n_steps} supersteps")
    _barrier(mesh)  # the files are written before any rank reads them
    s2 = distribute_shards(geom.scatter(load_matrix(f"{tmp}/ckpt_A.bin")), mesh)
    o2 = torch.from_numpy(load_matrix(f"{tmp}/ckpt_orig.bin").astype(np.int64))
    s2, _o, perm2 = lu_factor_steps(s2, geom, mesh, half, geom.n_steps, orig=o2,
                                    panel_algo="auto")
    res2 = lu_residual(A.astype(np.float64), gathered(s2, geom), perm2.cpu().numpy())
    out["restart_residual"] = res2
    say(f"post-restart residual = {res2:.3e}")
    bar(res2 < 1e-5, f"restart residual {res2:.3e}")

    # ---- 6. layout redistribution (COSTA role) ------------------------ #
    LU_host = gathered(LU, geom)
    if lead:
        step("redistribute between block-cyclic layouts without (N, N)")
        src = BlockCyclicLayout.for_grid(N, N, v, grid)
        dst = BlockCyclicLayout(M=N, N=N, vr=32, vc=32, Prows=4, Pcols=2)
        moved = transform(scatter(A, src), src, dst)
        ok = bool(np.array_equal(gather(moved, dst), A))
        print(f"conflux layout -> ScaLAPACK-style {dst.vr}x{dst.vc} on 4x2: "
              f"round-trip exact = {ok}; desc = {scalapack_desc(dst).tolist()}")
        bar(ok, "layout round trip")
        # the factors as ScaLAPACK local buffers (column-major + 9-int
        # descriptors): what a pdgetrs/pdgemm pipeline consumes
        locals_, descs = to_scalapack(LU_host, dst)
        ok = bool(np.array_equal(from_scalapack(locals_, dst), LU_host))
        print(f"LU factors -> ScaLAPACK locals on 4x2: round-trip exact = {ok}; "
              f"local[0][0] {locals_[0][0].shape} F-order, LLD = {int(descs[0][0][8])}")
        bar(ok, "ScaLAPACK export round trip")

    # ---- 7. QR: TSQR / CholeskyQR2, the full QR, least squares -------- #
    if lead:
        step("tall-skinny QR over the x axis: only (n, n) R blocks communicate")
        T = make_test_matrix(512, 24, dtype=np.float32)
        for algo in ("tsqr", "cholesky"):
            Q, R = world(4, 1, 1)(lambda m, algo=algo: qr_distributed_host(
                T, 4, mesh=m, algo=algo))[0]
            orth = float(np.linalg.norm(Q.T @ Q - np.eye(24)) / np.sqrt(24))
            rec = float(np.linalg.norm(Q @ R - T) / np.linalg.norm(T))
            out[f"{algo}_orth"], out[f"{algo}_rec"] = orth, rec
            print(f"{algo:9s} on 4x1x1: ||Q^T Q - I|| = {orth:.2e}, "
                  f"||A - QR||/||A|| = {rec:.2e}")
            bar(orth < 1e-5 and rec < 1e-5, f"{algo}: orth {orth:.2e}, rec {rec:.2e}")
    # the full block-cyclic QR on the same 2.5D grid, and least squares
    G = make_test_matrix(N, N, dtype=np.float32)
    Qf, Rf, _g = qr_blocked_distributed_host(G, grid, v, mesh=mesh)
    rec = float(np.linalg.norm(Qf @ Rf - G) / np.linalg.norm(G))
    out["full_qr_rec"] = rec
    say(f"full QR on {grid}: ||A - QR||/||A|| = {rec:.2e}")
    bar(rec < 1e-5, f"full QR reconstruction {rec:.2e}")
    bq = np.arange(N, dtype=np.float32) / N
    if lead:
        Gh = G[:, : N // 2]
        xq = lstsq(torch.from_numpy(Gh).to(dev), torch.from_numpy(bq).to(dev)).cpu().numpy()
        g = Gh.T @ (Gh @ xq - bq)
        out["lstsq_optimality"] = float(np.abs(g).max())
        print(f"lstsq (N x N/2): normal-equations optimality |A^T r| = "
              f"{out['lstsq_optimality']:.2e}")
        bar(out["lstsq_optimality"] < 1e-2, f"lstsq optimality {out['lstsq_optimality']:.2e}")
    # the same solve on the grid, through the block-cyclic factors (Q^H b
    # sums + distributed back substitution)
    qgeom = LUGeometry.create(N, N, v, grid)
    Qs, Rs = qr_factor_distributed(distribute_shards(qgeom.scatter(G), mesh), qgeom, mesh)
    xm = qr_lstsq_distributed(Qs, Rs, qgeom, mesh, torch.from_numpy(bq)).cpu().numpy()
    rel = float(np.linalg.norm(G @ xm - bq) / np.linalg.norm(bq))
    out["qr_lstsq_residual"] = rel
    say(f"qr_lstsq_distributed on {grid}: ||Ax-b||/||b|| = {rel:.2e}")
    bar(rel < 1e-4, f"qr_lstsq_distributed residual {rel:.2e}")
    return out


def _odd_grid(mesh) -> dict:
    """Step 8's factorization on the 3x2x1 world, every rank together."""
    from conflux_tpu_torch.geometry import LUGeometry
    from conflux_tpu_torch.lu.distributed import lu_factor_distributed
    from conflux_tpu_torch.parallel.mesh import distribute_shards, gather_shards
    from conflux_tpu_torch.validation import make_test_matrix

    ogeom = LUGeometry.create(384, 384, 64, mesh.grid)
    oA = make_test_matrix(384, 384, seed=8, dtype=np.float32)
    out, perm = lu_factor_distributed(distribute_shards(ogeom.scatter(oA), mesh), ogeom,
                                      mesh, election="butterfly", panel_algo="auto")
    return {"A": oA, "LU": ogeom.gather(gather_shards(out, mesh).cpu().numpy()),
            "perm": perm.cpu().numpy()}


def main(device=None) -> dict:
    """Run the tour on `device` (default: the card; "cpu" runs the
    kernels' plain versions). Returns each step's readings; a missed bar
    raises."""
    from conflux_tpu_torch import autotune
    from conflux_tpu_torch.geometry import Grid3
    from conflux_tpu_torch.parallel.mesh import run_threaded
    from conflux_tpu_torch.validation import lu_residual

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("torch_tour: no card (pass --platform cpu for the plain "
                               "versions on the CPU)")
        device = "cuda"
    cuda = torch.device(device).type == "cuda"

    def world(Px: int, Py: int, Pz: int):
        def run(fn):
            return run_threaded(Grid3(Px, Py, Pz), fn, device=device,
                                transport="staged" if cuda else None, timeout=300.0)
        return run

    N, v = 256, 16
    with tempfile.TemporaryDirectory() as tmp:
        out = world(2, 2, 2)(lambda mesh: _grid_steps(mesh, N, v, tmp, world))[0]

    # ---- 8. odd grids + measured dispatch ----------------------------- #
    # non-power-of-two grids are first-class: the butterfly election folds
    # its overflow ranks through the power-of-two subcube
    step("odd-grid butterfly election + measured dispatch")
    odd = world(3, 2, 1)(_odd_grid)
    perms = [r["perm"] for r in odd]
    bar(all(np.array_equal(p, perms[0]) for p in perms), "odd-grid ranks disagree on perm")
    ores = lu_residual(odd[0]["A"], odd[0]["LU"], perms[0])
    out["odd_perm"], out["odd_residual"] = perms[0], ores
    print(f"butterfly LU on {Grid3(3, 2, 1)} (odd Px): residual = {ores:.2e}")
    bar(ores < 1e-5, f"odd-grid residual {ores:.2e}")
    kind = autotune.detect_device_kind() if cuda else "cpu"
    rec = autotune.recommended("lu", 384, P=6, device_kind=kind)
    out["autotune_v"] = rec.knobs["v"]
    print(f"autotune.recommended('lu', 384, P=6) -> v={rec.knobs['v']}"
          f"  [{rec.provenance[:48]}...]")
    print("\nTour complete.", flush=True)
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser("torch_tour", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--platform", default=None, choices=["cpu"],
                   help="run the kernels' plain versions on the CPU (default: the card)")
    main("cpu" if p.parse_args().platform == "cpu" else None)
