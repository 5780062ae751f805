"""Single-card tuning sweep of the port's three grid cores (the counterpart
of `scripts/tpu_tune.py`; run on the card).

Times the distributed program of the chosen algorithm on a 1x1x1 grid at
bench scale across the knobs the phase tables (`chip_smoke.py` phase 39,
the miniapps' `--profile`) name as the levers:

  - matmul precision: HIGHEST (IEEE float32) vs HIGH for the library
    products; HIGH is one TF32 tensor-core pass on backend "xla" and the
    same IEEE K1 on backend "kernel" (K1 takes no precision);
  - panel_chunk (LU only): the nomination chunk height;
  - v: tile size (election work ~ N^2 v; GEMM efficiency grows with v);
  - RxC trailing-update segments and the election tree (LU).

It runs on the registry's backend and panel algo (`blas.set_backend`,
`set_panel_algo`: "kernel" by default). Prints one line per config:
GFLOP/s, then the residual against `residual_bound(N, float32)` (HIGH on
backend "xla" also against the TF32 bar, `residual_bound(..., precision=)`,
which has none below 1 from N=65536).

Usage:
    python scripts/torch_tune.py [-N 32768] [--reps 2] [--algo lu]
    python scripts/torch_tune.py --algo cholesky -N 32768
    python scripts/torch_tune.py --algo qr -N 16384 --configs highest:0:1024
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

PRECISIONS = ("high", "highest")
LU_CONFIGS = [
    ("highest", 8192, 1024, None, "pairwise"),
    ("high", 8192, 1024, None, "pairwise"),
    ("highest", 12288, 1024, None, "pairwise"),
    ("highest", 4096, 1024, None, "pairwise"),
    ("highest", 8192, 2048, None, "pairwise"),
    ("high", 8192, 2048, None, "pairwise"),
    ("highest", 8192, 512, None, "pairwise"),
]
OTHER_CONFIGS = [
    ("highest", 0, 1024, None, "pairwise"),
    ("high", 0, 1024, None, "pairwise"),
    ("highest", 0, 512, None, "pairwise"),
    ("highest", 0, 2048, None, "pairwise"),
]


def parse_configs(ap: argparse.ArgumentParser, text: str, algo: str) -> list:
    """The `--configs` list precision:chunk:v[:RxC[:tree]] as (precision,
    chunk or None, v, segs or None, tree) tuples; a malformed entry is an
    argparse error (before any device work)."""
    from conflux_tpu_torch.cli.common import segs_arg

    configs = []
    for c in text.split(","):
        parts = c.split(":")
        if not 3 <= len(parts) <= 5 or parts[0] not in PRECISIONS:
            ap.error(f"bad config {c!r}: want precision:chunk:v[:RxC[:tree]] with precision "
                     f"in {sorted(PRECISIONS)}, RxC segment counts ('-' = library default), "
                     "tree in pairwise|flat")
        p, chunk, v = parts[:3]
        segs = None
        if len(parts) > 3 and parts[3] not in ("", "-"):
            try:
                segs = segs_arg(parts[3])
            except argparse.ArgumentTypeError as e:
                ap.error(f"bad segment field in config {c!r}: {e}")
        tree = parts[4] if len(parts) > 4 and parts[4] not in ("", "-") else "pairwise"
        if tree not in ("pairwise", "flat"):
            ap.error(f"bad tree field {tree!r} in config {c!r}: want pairwise|flat (or '-' "
                     "for the default)")
        if algo != "lu" and tree != "pairwise":
            ap.error(f"config {c!r}: the tree field is LU-only (algo={algo})")
        if not re.fullmatch(r"\d+", chunk) or not re.fullmatch(r"\d+", v) or int(v) < 1:
            ap.error(f"bad config {c!r}: chunk must be a non-negative integer (0 = the "
                     "library default) and v a positive integer")
        configs.append((p, int(chunk) or None, int(v), segs, tree))
    return configs


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-N", type=int, default=32768)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--algo", default="lu", choices=["lu", "cholesky", "qr"])
    ap.add_argument("--update", default="segments", choices=["segments", "block"],
                    help="LU trailing-update partitioning (every LU config of the run)")
    ap.add_argument("--lookahead", action="store_true",
                    help="the software-pipelined loop (every config of the run)")
    ap.add_argument("--configs", default=None,
                    help="comma list precision:chunk:v[:RxC[:tree]], e.g. "
                    "highest:8192:1024,high:8192:1024:16x16:flat (chunk ignored for "
                    "cholesky/qr; pass 0; RxC = LU row x col segment counts, QR 1xC, '-' "
                    "for the library default; tree = pairwise|flat, LU only)")
    return ap


def main(argv=None, results: list | None = None) -> int:
    """Run the sweep; each config's record (its knobs, GFLOP/s, residual,
    whether it meets the float32 bar and whether it meets the bar of the
    precision it ran at) is appended to `results` when given. Returns 0 when every config ran with a finite residual."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.update != "segments" and args.algo != "lu":
        ap.error("--update applies to --algo lu only")
    # configs are checked before the card is touched
    configs = parse_configs(ap, args.configs, args.algo) if args.configs else None

    import math

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_tune: no CUDA card (the sweep measures the card)", file=sys.stderr)
        return 2
    from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, LUGeometry
    from conflux_tpu_torch.ops import blas
    from conflux_tpu_torch.parallel.mesh import distribute_shards, make_mesh
    from conflux_tpu_torch.validation import residual_bound

    N = args.N
    grid = Grid3(1, 1, 1)
    mesh = make_mesh(grid)
    backend = blas.get_backend()
    # the port's rate lines: (2/3) N^3, (1/3) N^3, 2 N^3 - 2 N^3 / 3 (QR, M = N)
    flop_coeff = {"lu": 2 / 3, "cholesky": 1 / 3, "qr": 4 / 3}[args.algo]
    if configs is None:
        configs = LU_CONFIGS if args.algo == "lu" else OTHER_CONFIGS
    bar = residual_bound(N, torch.float32)
    try:
        tf32_bar = residual_bound(N, torch.float32, precision="high")
    except ValueError:  # no TF32 bar below 1 at this N
        tf32_bar = None
    failed = 0
    for pname, chunk, v, segs, tree in configs:
        cfg = (f"algo={args.algo} backend={backend} precision={pname} "
               f"chunk={'default' if chunk is None else chunk} v={v}")
        if args.algo == "qr":
            if segs is not None and segs[0] != 1:
                print(f"{cfg}: segs {segs} not supported (qr segments columns only; "
                      "write the 4th field as 1xC)", flush=True)
                failed += 1
                continue
            seg_kw = {} if segs is None else {"csegs": segs[1]}
            seg_lbl = "lib" if segs is None else f"1x{segs[1]}"
        else:
            seg_kw = {} if segs is None else {"segs": segs}
            seg_lbl = "lib" if segs is None else f"{segs[0]}x{segs[1]}"
        if args.algo == "lu":
            from conflux_tpu_torch.lu.distributed import lu_factor_distributed
            from conflux_tpu_torch.validation import lu_residual_distributed

            geom = LUGeometry.create(N, N, v, grid)

            def make(geom=geom):
                # bench.py's input (randn + 2 I, seeded): the residual
                # regenerates it bit for bit
                gen = torch.Generator(device="cuda").manual_seed(0)
                A = torch.randn((geom.M, geom.N), generator=gen, device="cuda")
                A.diagonal().add_(2.0)
                return A

            def factor(lu_in, geom=geom, chunk=chunk, pname=pname, seg_kw=seg_kw, tree=tree):
                return lu_factor_distributed(lu_in, geom, mesh, pname, panel_chunk=chunk,
                                             donate=True, tree=tree, update=args.update,
                                             lookahead=args.lookahead, **seg_kw)

            def residual(out, geom=geom, make=make):
                return lu_residual_distributed(make(), out[0], out[1], geom, mesh)
        elif args.algo == "cholesky":
            from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed
            from conflux_tpu_torch.io import generate_spd_local
            from conflux_tpu_torch.validation import cholesky_residual_distributed

            geom = CholeskyGeometry.create(N, v, grid)

            def make(geom=geom):
                return distribute_shards(
                    lambda px, py: generate_spd_local(geom, px, py, dtype=np.float32),
                    mesh, shape=(1, 1, geom.Ml, geom.Nl), dtype=np.float32)

            def factor(spd_in, geom=geom, pname=pname, seg_kw=seg_kw):
                return (cholesky_factor_distributed(spd_in, geom, mesh, pname, donate=True,
                                                    lookahead=args.lookahead, **seg_kw),)

            def residual(out, geom=geom, make=make):
                return cholesky_residual_distributed(make(), out[0], geom, mesh)
        else:
            from conflux_tpu_torch.qr.distributed import qr_factor_distributed
            from conflux_tpu_torch.validation import qr_residual_distributed

            geom = LUGeometry.create(N, N, v, grid)

            def make(geom=geom):
                gen = torch.Generator(device="cuda").manual_seed(0)
                return torch.randn((geom.M, geom.N), generator=gen, device="cuda")

            def factor(qr_in, geom=geom, pname=pname, seg_kw=seg_kw):
                return qr_factor_distributed(qr_in, geom, mesh, pname, donate=True,
                                             lookahead=args.lookahead, **seg_kw)

            def residual(out, geom=geom, make=make):
                return qr_residual_distributed(make(), out[0], out[1], geom, mesh)[0]
        try:
            out = factor(make())  # warm-up
            torch.cuda.synchronize()
            times = []
            for _ in range(args.reps):
                s = make()
                del out
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = factor(s)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            gflops = flop_coeff * N ** 3 / (sum(times) / len(times)) / 1e9
            print(f"{cfg} segs={seg_lbl} tree={tree} lookahead="
                  f"{'on' if args.lookahead else 'off'} update={args.update}: "
                  f"{gflops:.1f} GFLOP/s", flush=True)
            res = float(residual(out))
            del out
            torch.cuda.empty_cache()
        except (RuntimeError, ValueError) as e:  # out of memory, or a knob refused
            print(f"{cfg} segs={seg_lbl} tree={tree}: FAILED {e}", flush=True)
            failed += 1
            torch.cuda.empty_cache()
            continue
        tf32 = backend == "xla" and pname == "high"
        meets = bool(math.isfinite(res) and res <= bar)
        # the bar of the factor's own precision: TF32's where it ran TF32
        own = (tf32_bar is not None and bool(math.isfinite(res) and res <= tf32_bar)
               if tf32 else meets)
        tnote = ("" if not tf32 else "; no TF32 bar below 1 at this N" if tf32_bar is None
                 else f"; TF32 bar {tf32_bar:.3e}: {'meets' if own else 'misses'}")
        print(f"    residual={res:.3e} (float32 bar {bar:.3e}: "
              f"{'meets' if meets else 'misses'}{tnote})", flush=True)
        failed += not math.isfinite(res)
        if results is not None:
            results.append(dict(algo=args.algo, backend=backend, precision=pname,
                                panel_chunk=chunk, v=v, segs=segs, tree=tree,
                                gflops=gflops, ms=1e3 * sum(times) / len(times),
                                residual=res, meets_f32_bar=meets, meets_bar=own))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
