"""Drive the PyTorch/CUDA port (`conflux_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. device: the card's name, count and power limit (fails without a card);
  2. build: the hand-written kernels from `conflux_tpu_torch/ops/csrc`;
  3. K1 (`hopper_kernels.gemm`) against its plain version at the main
     path's first trailing update, ragged shapes, a strided view and bf16,
     and at the Cholesky path's in-place updates of a strided trailing view
     (N=32768 v=1024, N=4096 v=256 at two offsets), naming the instance
     (TMA or SIMT) each call ran; its time with the SM clock under load and
     the bound at that clock;
  4. K2 (`hopper_kernels.lu_block`) against its plain version at the main
     path's (4096, 128) and (2048, 128) blocks, all-live and partly dead,
     and batched at (8, 4096, 128), (4, 2048, 128), (12, 4096, 128) (two
     waves of clusters) and the N=32768 cell's (4, 8192, 128) chunks: each
     slot bitwise a B=1 launch, each call's launches its route's; on three
     (512, 128) blocks whose elections meet NaN (all zero, a NaN column 0,
     one NaN in column 0), alone and in a batch; times at B=1, the two
     batches and the cell's (4, 8192, 128), (2, 2048, 128) and (1, 2048,
     128) beside `torch.linalg.lu_factor` on the same batch, each with its
     route;
  5. the main path through the miniapp's `main(argv)`: N=32768 f32 v=1024
     with --validate, then N=8192 with --validate --refine 4, with each
     kernel's launches counted over each run: K2's must be the count
     `blas.lu_block_launches` predicts (1600 at N=32768, warm-up + 1), and
     every K1 launch the TMA instance;
  6. CUDA-event times of each kernel, its plain version and one library
     call at the main path's shapes, beside each kernel's bound;
  7. K3 against its plain versions on packed LUs (K4's) and Cholesky
     factors (K5's): one substitution (`hopper_kernels.btrsm`), lower unit
     and upper, and a whole solve round (`btrsm_pair`: LU with the row
     permutation, SPD back through L^T read in place, each with the probe
     stats), at the serving shapes (32, 256, 256) and (32, 1024, 1024)
     with one right-hand side per system, (32, 256, 256) with 16, and a
     ragged n=200; times at the first three beside `solve_triangular`
     (one substitution), `lu_solve` and `cholesky_solve` (a round), each
     a call's CUDA-event time and its device time in a CUDA graph; then
     64-wide diagonal blocks (ragged n=200, through `btrsm`, `btrsm_pair`
     and `blocked_trsm`) and a round at n=20000, whose x blocks do not
     fit shared memory;
  8. K4 (`hopper_kernels.batched_lu`) against its plain version at
     (32, 256, 256) and (32, 1024, 1024) f32, (8, 256, 256) f64, ragged
     (4, 200, 200) and (3, 1000, 1000) and a batch with one NaN slot:
     pivots equal, slot bits independent of the batch, with times and each
     launch's block width kb and cluster size;
  9. serving (a), the reference's serving shape (`bench_serve.py`): a
     (32, 256, 256) f32 plan, v=128, factored once and served 16 rounds
     of one right-hand side per system by `solve` and `solve_checked`
     (K4 once, K3 once per round: 32 launches);
 10. serving (b), the factor lane at the batched factor's N=1024 ceiling:
     32 (1024, 1024) f32 systems through `_factor_health_fn(32)` (one K3
     launch, its verdict from the round's probe stats), and `plan.factor`
     of slot 0 bitwise slot 0 of the bucket;
 11. K5 (`hopper_kernels.batched_chol`) against its plain version, bit for
     bit, at (32, 256, 256) and (32, 1024, 1024) f32, (8, 256, 256) f64,
     ragged (4, 200, 200) and (3, 1000, 1000) and a batch with non-SPD
     slots (NaN alone, the neighbours' bits kept); a B=1 launch gives a
     slot's bits of the batch; with times, kb and the cluster size;
 12. serving (c), SPD plans at the reference's serving shape: a
     (32, 256, 256) f32 kind="chol" plan, v=128, factored once and served
     16 rounds by `solve` and 16 by `solve_checked` (K5 once, K3 once per
     round);
 13. serving (d), the SPD factor lane at N=1024: 32 (1024, 1024) f32
     systems through `_factor_health_fn(32)` of a kind="chol" plan (one K3
     launch), and
     `plan.factor` of slot 0 bitwise slot 0 of the bucket;
 14. the Cholesky miniapp's `main(argv)`: N=32768 f32 --tile 1024 with
     --validate (the tile `choose_cholesky_tile` picks), then BASELINE
     config #2, N=4096 --tile 256 --validate --refine 4; K1's launches
     counted over each run, every one the TMA instance;
 15. (L64) BASELINE config #1 on the library route the JAX miniapp runs
     (`--dtype float64`: backend "xla", panel algo "auto", its `_route_`
     line checked), N=2048 b=128 --validate --refine 2, and (L64-full) the
     same route at N=32768 b=1024 (the library tournament above 4096 rows)
     with its rate against the float64 peak, one tournament round and the
     pivots' host conversion timed; no kernel launches on this route, and
     the port's library LU of a batch of panels taller than MAGMA's
     batched limit prints nothing to the process's stdout;
 16. (Lxla32) the float32 library route at N=32768 v=1024 through
     `lu_factor_blocked(..., backend="xla", panel_algo="auto")`, beside
     phase 5's kernel route;
 17. (C64) the Cholesky miniapp at float64, N=32768 --tile 1024
     --validate, and a complex128 HPD Cholesky (`make_hpd_matrix`) on
     backend "xla" at N=2048;
 18. serving (e), a backend="xla" f32 LU plan at (32, 1024, 1024), v=256:
     factor, the factor lane's checked program, 16 solve and 16 checked
     rounds (one K3 launch each; nothing printed to the process's stdout),
     the factor's library LU and pivot conversion timed apart at each
     superstep's panels, and a non-SPD slot of an xla SPD plan's bucket
     (NaN, flagged alone);
 19. serving (f), the HPL-MxP plan: a kernel-route (32, 1024, 1024) f32
     plan with factor_dtype bfloat16 and refine 2, v=256: K1, K2 and K3
     launches against the counts the code predicts (K1 once per system
     and superstep), the factor's residual before any sweep, the first K1
     and K2 call at each of the factor's shapes held against its plain
     version on the path's own operands, the solve after 2 sweeps, and
     K3's bfloat16-T
     instance on the plan's factor against its plain version and bit for
     bit the float32 instance on the upcast factor, with both times;
 20. (s) the solver API at N=4096, float64 and float32: `solve` (N=4093,
     padded) against `torch.linalg.solve`, `slogdet_from_lu`,
     `inv_from_lu`, `cond_estimate_1` (within 3x of `torch.linalg.cond(A,
     1)`), and FGMRES on bf16 factors at the JAX test's setup (1e-6, where
     6 classic sweeps stay above 1e-4); the float32 factor's residual, and
     its first K1 and K2 call at each shape held against the plain
     versions as in (f);
 21. Woodbury serving at bench_refresh.py's shapes, float32, k=16: a
     (1024, 1024) plan v=256, (32, 256, 256) v=128 and (32, 1024, 1024)
     v=256, 8 rounds each of update(U, V, replace=True), solve and
     solve_checked (K4 once, K3 once per capacitance, Woodbury solve and
     checked solve: 24), max |(A + U V^T) x - b| < 1e-4 and clean
     verdicts, times per update, round and checked round beside the
     undrifted session's; then on the (1024, 1024) plan 9 accumulated
     drifts (K3 at k=16, 32, 64 and 128, one refactor past max_rank),
     refactor() and refine_checked, and a near-singular drift that trips
     the cond trigger (backward error < 1e-5); every first K3 round at a
     new shape held against its plain version on the path's operands;
 22. the precision ladder on a (32, 1024, 1024) kernel-route f32 LU plan,
     v=256, refine 1: factor(precision="bf16_ir") (K1 96 and K2 launches
     as predicted, each shape held against its plain version; nbytes below
     0.85x the native session's), solves at bf16_ir, f32 (bit for bit the
     native session: K4 factors) and f64 (library factor, no K1/K2/K4; K3's
     float64-T instance), K3's bf16, f32 and f64 instances held against the
     plain version, and 'auto' with `resilience.escalate_precision` on
     cond-1e6 systems (the bf16 rung trips, the ladder climbs, the rung
     sticks);
 23. the QR miniapp's `main(argv)`: --full -M 32768 --cols 32768 -b 1024
     --validate, through `qr_factor_distributed` on 1x1x1 (only K1
     launches, as many as `qr.distributed.gemm_launches` predicts, the
     first call at each shape held against its plain version, all TMA),
     and tall mode at -M 1048576 --cols 256, --algo tsqr and cholesky,
     --validate, which launch no kernel (orthogonality and reconstruction
     at most `residual_bound(N, f32)`), ms and TFLOP/s at the LAPACK count
     2MN^2 - 2N^3/3; the tree's chunk round (8, 4096, 1024) timed on
     torch's library QR;
 24. kind="qr" plans at (16384, 1024) f32 and f64 (factor, the factor
     lane's checked program, 16 solve and 16 checked rounds against
     `torch.linalg.lstsq`, the verdict tripping on a corrupted R) and
     `lstsq` at (32768, 1024) f64 and f32 with bfloat16 factors and 2
     sweeps; no kernel launches;
 25. the serving engine's solve lane (`engine.ServeEngine`) at
     bench_engine.py's shape: two sessions of a (32, 256, 256) f32 LU plan
     and one of a (256, 256) plan, v=128, 128 requests of widths 1,1,2,4,
     max_coalesce_width 32, max_batch_delay 2 ms, after prewarm of widths
     1..32: every answer bitwise the direct `session.solve`, max |A x - b|
     below 1e-4, no kernel build (`profiler.compile_count`) and no program
     made (`trace_counts`) after prewarm, one K3 launch per batch, the
     first call of K3 at each shape the engine gives it held against its
     plain version; solves/s beside the sequential loop, the coalesced
     mean and p50/p95/p99; then a guarded engine (`HealthPolicy()`) that
     refuses a NaN rhs at submit and fails a request poisoned after
     admission alone, the rest bitwise, its K3 rounds with the fused probe
     held the same way;
 26. the factor lane: 32 cold starts of a (256, 256) f32 LU plan through
     `submit_factor` after prewarm of factor batches 1..32, then of an SPD
     plan: one K4 (K5) launch per coalesced batch, every session bitwise
     `plan.factor`'s, no build after prewarm; sessions/s beside the
     sequential `plan.factor` loop (K4 and K5 are held against their plain
     versions at the full bucket (32, 256, 256) in phases 8 and 13, and a
     slot's factors do not depend on the bucket);
 27. gang-resident stacks: 16 (256, 256) f32 sessions, stack_sessions
     with max_stack 16, widths 1,1,1,2, 8 rounds of one request per
     session, then under a guarded engine, then with 4 members drifted by
     rank 4 under a guarded engine: one
     K3 launch per stacked dispatch, every stack exclusion 0, max |A x - b|
     below 1e-4, the first K3 round at each shape (plain, fused probe,
     Woodbury base) held against its plain version, a slot's answer
     bitwise invariant to the stack bucket and the pad slots and bitwise
     the session's own solve; solves/s beside the per-session dispatch;
 28. tiered residency (`tier.ResidentSet`, cell n): bench_engine.py
     --tier's shape (32 (256, 256) f32 LU sessions over 4 device slots, 128
     Zipf(1.1) requests) beside the always-refactor LRU loop; then 128
     (1024, 1024) sessions, v=256, over a byte cap of 16 sessions with at
     most 96 on the host (the rest on a temporary disk_dir), 1024 width-1
     Zipf(1.1) requests through `ServeEngine(residency=...)`: every answer
     bitwise the session's answer before any spill, the byte high-water
     at most the cap, every revived session's first K3 round held against
     `btrsm_pair_plain`, K3 once per batch, no build after prewarm; four
     sessions drifted past `revive_refactor_rank` and touched together
     revive through the factor lane (K4 launches == its batches, max
     |(A + U V^T) x - b| < 1e-4); spills, revives, fault-in p50/p95/p99,
     solves/s, `memory_allocated` (each leg's fault-in percentiles its
     own), and the host time of four spill waves of 8 sessions;
 29. checkpoint -> kill -> restore: `scripts/torch_ckpt_roundtrip.py`
     --save and --restore as two processes (8 (1024, 1024) sessions,
     plain, drifted and refined, some on the host and disk tiers;
     answers, verdicts, counters and drift ranks bitwise in a fresh
     process; a delta generation writes 2 records and carries 6);
 30. the adaptive controller (cell o) on BENCH_ADAPTIVE.json's trace: a
     (32, 256, 256) f32 LU plan, 2 sessions, ramp, burst and width-drift
     regimes of 2 s under `AdaptiveController(slo_p99_ms=25,
     interval=0.25)` (operating point persisted to a temporary file),
     beside a static engine (2 ms, 1024 pending), then a scripted width
     growth to 64: at least 12 ticks and no tick error, every width
     growth bucket-ready with no build and no program across the switch,
     sampled answers bitwise the direct solves, every K3 round at a new
     shape held against its plain version; p99 per regime printed;
 31. the serve fabric (`fabric.ServeFabric`, cell p): in process, three
     `LocalHost`s on the card with 12 sessions (six (32, 256, 256) f32 LU
     plans, v=128, four (1024, 1024) LU plans, v=256, two drifted by rank
     16, two (32, 256, 256) SPD plans), K4/K5 launches equal to the opens'
     factor-lane batches, 192 requests of widths 1,1,2,4 from 8 threads
     bitwise the direct `session.solve` (the drifted sessions' too; first
     K3 round at each shape held
     against its plain version, K3 once per engine batch), one host
     killed (bitwise, 0 lost, census conserved), one live migration and a
     replicas=2 kill that re-points; then `scripts/torch_fabric_drill.py`:
     six worker processes on the card over the shm wire (2 workers against
     1 bitwise, migration, SIGKILL -> HostUnavailable -> fail-over, K=2
     re-point, a torn reply read as WireCorrupt, no /dev/shm leak), each
     worker's K3/K4/K5 launches read through the host `stats` op.
 32. bench.py's configuration on the card (`bench.py:79-122`):
     `lu_factor_distributed` on a world-size-1 1x1x1 mesh at N=32768,
     v=1024, f32, on randn + 2 I from a seeded generator, one warm-up (its
     first K1 and K2 call at each shape held against the plain versions)
     and 3 timed runs (ms, GFLOP/s beside phase 5's route), the grid
     residual, `lu_factor_steps` in two halves bitwise the uninterrupted
     run, and the miniapp's route to it (-N 32768 -b 256 --p_grid 1,1,1
     --validate: 128 supersteps); every K1 launch the TMA instance;
 33. CONFCHOX: `cholesky_factor_distributed` at 1x1x1, N=32768, v=1024,
     f32, on `io.generate_spd_local`'s SPD (K1 held the same way), 3 timed
     runs and the grid residual;
 34. several ranks on the one card: threaded worlds on cuda:0 over the
     "staged" transport (gloo through host copies, the bytes printed): LU
     at 2x2x1 (gather) and 3x1x1 (butterfly) and Cholesky at 2x2x1, N=8192,
     v=256, within the residual bar, and at N=2048, v=128 the card's
     pivots equal to the CPU threaded world's;
 35. distributed QR at full width: `qr_factor_distributed` on a
     world-size-1 1x1x1 mesh at M = N = 32768, v = 1024, f32 (warm-up with
     each K1 shape held against its plain version and the launches
     against `gemm_launches`, 2 timed runs, ms and TFLOP/s beside the card
     and its power limit, `qr_residual_distributed` within the bar); at
     N=16384 lookahead and `qr_factor_steps` in two halves bitwise the
     plain run; `tsqr_distributed` and `cholesky_qr2_distributed` at
     (1048576, 256), `lstsq_distributed` and `qr_lstsq_distributed` at
     (32768, 1024) f32 and f64 within 1e-4 and 1e-9 of
     `torch.linalg.lstsq`; the native host scatter/gather of the N=32768
     matrix bitwise the numpy path, both host times;
 36. several ranks on the one card over "staged" (correctness, not
     scaling): `tsqr_distributed` at Px = 4 (gather, butterfly) and 3
     (butterfly) on (262144, 256), R bitwise on every rank;
     `qr_factor_distributed` at 2x2x1 and 2x1x2, N=8192, v=256, and the
     QR miniapp's --full --p_grid 2,2,1 route, within the bar; at N=2048
     R allclose the CPU threaded world's; the staged bytes;
 37. the serving mesh lane on the one card, `batch_mesh(["cuda:0",
     "cuda:0"])` (two shards of one card: correctness, not scaling): (a)
     BENCH_MESH.json's (32, 256, 256) f32 plan, v=128: K4 once per shard
     (held against its plain version), the mesh plan bitwise the
     one-device plan, an engine's 128 requests of widths 1,1,2,4 after
     prewarm bitwise the bare loop with K3 twice a batch (held), no build
     after prewarm, `mesh_plan_unsupported` 0, solves/s beside the bare
     loop and the one-device plan's engine; an SPD mesh plan through K5
     (held); (b) the large-N session (2, 4096, 4096) f32: a checked
     engine factor (K4 once per shard, held), solves bitwise the bare
     session, spill and revive through host and disk and
     checkpoint()/restore() bitwise, K4 per shard beside
     `torch.linalg.lu_factor` of (1, 4096, 4096), a NaN rhs refused at
     admission and a deadline evicting a mesh request mid-window;
 38. two lanes on the one card, `ServeEngine(devices=["cuda:0",
     "cuda:0"])`: BENCH_FLEET.json's trace ((32, 256, 256) plan, 128
     requests of widths 1,1,2,4 over 4 sessions pinned two to a lane, 32
     pooled cold starts, max_factor_batch 8) bitwise the one-lane
     engine's, every pooled session bitwise `plan.factor`'s, K3 once per
     batch and K4 once per factor batch (held), per-lane telemetry; a kill
     on lane 0's dispatcher fails only its request and the lane revives;
     solves/s and sessions/s for two lanes and one.
 39. the per-phase device tables of the grid routes (`profiler.trace`,
     `phase_table`, as the miniapps' --profile prints them): the LU grid
     program at N=32768, v=1024, f32, 1x1x1, CONFCHOX at N=32768 and the
     grid QR at N=16384 (a depth cut), one untraced and one traced run
     each: every phase of the JAX package's program in the table, every
     device event counted once, every K1 launch under step6_dgemm /
     computeA11 / qr_trailing_update and every K2 launch under
     step1_pivoting as the launch counts say, the traced output bitwise
     the untraced;
 40. `scripts/torch_soak.py --serve --lockcheck`, then `--tier
     --lockcheck`, 30 s each on the card: 0 failed trials, 0 lock-order
     cycles, 0 engine locks held across a serve.* dispatch region, K3 and
     K4 launched under both;
 41. matmul precision: the TF32 library product at 8192x1024.1024x8192
     (its error between 10x the IEEE product's and the TF32 bar, both
     times), HIGHEST bitwise `torch.matmul` with TF32 off, IEEE products
     bitwise while another thread runs TF32 ones (200 rounds), kernel
     plans at DEFAULT bitwise their HIGHEST plans with K1, K2, K3 and K4
     held against their plain versions, the TF32 update in place into a
     strided block of a larger matrix (2D and batched) against float64,
     the grid LU at N=32768 on backend "xla" at HIGHEST and HIGH (ms,
     residuals, per-phase tables with step6_dgemm), HIGH's residual at
     N=8192 and 16384, two controls the TF32 bar must refuse (TF32
     products skipped; operands rounded to bfloat16), and
     `solve_distributed` at N=16384: HIGHEST with 3 classic sweeps within
     1e-6, HIGH's classic sweeps and GMRES-IR within it or warning;
 42. the tuning sweep, `scripts/torch_tune.py`, at N=32768 --reps 1 on a
     short config list (the autotune rule's segs 4x4 beside the default),
     on backend "kernel" and on "xla", each config within its precision's
     bar;
 43. the soaks, `scripts/torch_soak.py` in this process under lockcheck:
     the configuration soak for 60 s (the grid LU, Cholesky and QR over
     the reference's sampled grids, widths, dtypes and knobs, on threaded
     worlds of staged ranks sharing the card), then --precision, --qos,
     --adaptive, --gang, --fleet, --mesh and --scale for 10 s each: each
     at least 1 trial, 0 failed, 0 lockcheck violations; K1 launched
     under the configuration soak (its "kernel"-backend float32 and
     bfloat16 draws), K3 and K4 under every serving mode (no mode opens
     an SPD plan, so none needs K5); the draws per core and dtype;
 44. `scripts/torch_accuracy_demo.py`'s sweeps at N=16384, v=1024
     (BASELINE.md's solve bar): float32 factors (the first K1 and K2 call
     at each shape held against the plain versions) and bfloat16 factors,
     refined to depths 0, 2 and 4 with float64 strip residuals; the
     float32 residual at depth 4 <= 1e-6, A intact after each donated
     factorization, K1 and K2 launched in both;
 45. `examples/torch_tour.py` on the card: its eight steps on threaded
     worlds of staged ranks sharing cuda:0 (2x2x2, 4x1x1, 3x2x1), every bar
     of the JAX tour, the first K1 and K2 call at each shape held, both
     launched;
 46. `scripts/torch_replay.py --smoke` in this process: the control-plane
     leg, 2000 sessions on two LocalHost engines at 5 device slots each
     under a 10 s open-loop trace, and the chaos leg's host kill; every
     reference smoke gate and invariant, the first K3 and K4 call at each
     shape held, both launched.
Each serving phase sets the launch counts to 0 just before it and reads
them just after; K3 and the plan's factor kernel (K4 or K5) must both have
launched in it, K3 once per blocked solve round (phase 29 reads the counts
of its two processes from their last lines, phase 31 its drill's workers'
from the drill's last line; phase 30 serves solves only, K3).

The line before the last is the kernels' JSON record (K3's entry: the LU
round, `btrsm_pair`, at serving (a)'s (32, 256, 256) with one right-hand
side; its times, as every kernel's, CUDA events around calls of the
Python entries), and the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

K1_TOL_F32 = 1e-5     # relative Frobenius: only the summation order differs
K1_TOL_BF16 = 2 ** -8  # relative Frobenius: one bf16 rounding of the f32 sum
K2_TOL = 1e-5         # allclose atol and rtol: kernel and plain share arithmetic
K3_TOL = 1e-5         # relative Frobenius: only the summation order differs
K3_STATS_TOL = 1e-4   # probe stats: error over sum |terms|, the summation order's
# max abs error of K4's factors (entries O(1)) against the plain version:
# f32 emulates the FMA in f64, exact but for double-rounding ties, whose
# 1-ulp differences later updates carry; f64 rounds its update twice
K4_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
K4_WA_TOL = 1e-5      # relative Frobenius of the probe rows wA
SOLVE_TOL = 1e-4      # max |A x - b|, the JAX bar (tests/test_batched_trsm.py:185)
BF16_FACTOR_BAR = 1e-2  # LU residual of bf16-stored factors (the port's bf16 tests)
# K5 and its plain version round each product, quotient, difference and
# square root once, in the same order: bit for bit
K5_TOL = 0.0
K5_WA_TOL = 1e-5      # relative Frobenius of the probe rows wA


CARD = ""  # "name, power limit" of the card, as nvidia-smi prints them (phase 1)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of fn() per call: `iters` calls captured in one CUDA
    graph and replayed, so that the host's time between launches (a
    wrapper's checks and allocations) is not counted."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    # conflint: disable=CFX-RECOMPILE a timing helper: one capture per measurement, by design
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def rel_fro(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.float(), ref.float()
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(f"[device] {device['kind']} x{device['count']}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)  # name, power limit
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    return device


def phase_build() -> None:
    from conflux_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    took = _build.build_seconds
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'%.1f s' % took if took is not None else 'reused a build'})",
          flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def _sm_clocks(fn) -> tuple[float, float]:
    """Run fn() while `nvidia-smi` samples the SM clock; return the median
    sampled and the maximum SM clock, in MHz."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        smi.stdout.readline()  # sampling has started (this sample precedes the load)
        fn()
    finally:
        smi.terminate()
    rows = [ln.split(",") for ln in smi.communicate()[0].splitlines() if ln.strip()]
    check(len(rows) > 0, "nvidia-smi sampled no SM clock under the load")
    sampled = sorted(float(r[0]) for r in rows)
    return sampled[len(sampled) // 2], float(rows[-1][1])


def phase_k1(rec: dict) -> None:
    from conflux_tpu_torch.ops.hopper_kernels import gemm, gemm_instance, gemm_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    # the main path's first trailing update: L10 (31744, 1024) @ A01 (1024,
    # 31744) subtracted from the trailing block in place
    M, K = 32768 - 1024, 1024
    a = torch.rand((M, K), generator=gen, device=dev) * 2 - 1
    b = torch.rand((K, M), generator=gen, device=dev) * 2 - 1
    c = torch.rand((M, M), generator=gen, device=dev) * 2 - 1
    want = gemm_plain(a, b, c, alpha=-1.0)
    got = c.clone()
    inst = gemm_instance(a, b, got, got)
    gemm(a, b, c=got, alpha=-1.0, out=got)
    torch.cuda.synchronize()
    err = rel_fro(got, want)
    rec["max_abs_err"] = float((got - want).abs().max())
    print(f"[K1] {M}x{K} @ {K}x{M} f32 in place ({inst} instance): rel_fro {err:.2e} "
          f"max_abs {rec['max_abs_err']:.2e} (bound {K1_TOL_F32:g})", flush=True)
    check(inst == "tma", "K1 main-path shape does not run the TMA instance")
    check(err <= K1_TOL_F32, f"K1 f32 main-path shape rel_fro {err:.3e}")
    del want, got

    # ragged shapes on both instances (rows with a 16-byte pitch: TMA; a
    # pitch of 130 or 401 floats: SIMT), a strided view and bf16
    big = torch.rand((300, 401), generator=gen, device=dev) * 2 - 1
    pad = torch.rand((1100, 1004), generator=gen, device=dev) * 2 - 1
    cases = [
        ("ragged (100, 60, 130)", big[:100, :60].contiguous(),
         big[100:160, :130].contiguous(), None, K1_TOL_F32, "simt"),
        ("ragged (1000, 1000, 777) views", pad[:1000, :1000], pad[:1000, 200:977],
         pad[100:1100, 4:781], K1_TOL_F32, "tma"),
        ("strided views ld=401", big[3:103, 5:65], big[110:170, 7:138],
         big[180:280, 200:331], K1_TOL_F32, "simt"),
    ]
    ab = (torch.rand((4096, 1024), generator=gen, device=dev) * 2 - 1).bfloat16()
    bb = (torch.rand((1024, 4096), generator=gen, device=dev) * 2 - 1).bfloat16()
    cb = (torch.rand((4096, 4096), generator=gen, device=dev) * 2 - 1).bfloat16()
    cases.append(("bf16 (4096, 1024, 4096)", ab, bb, cb, K1_TOL_BF16, "tma"))
    for name, x, y, z, tol, expect in cases:
        want = gemm_plain(x, y, z, alpha=-1.0)
        # out's rows on a 16-byte pitch: the other operands pick the instance
        per = 16 // want.element_size()
        out = torch.empty((want.shape[0], -(-want.shape[1] // per) * per), dtype=want.dtype,
                          device=dev)[:, :want.shape[1]]
        inst = gemm_instance(x, y, z, out)
        gemm(x, y, c=z, alpha=-1.0, out=out)
        torch.cuda.synchronize()
        err = rel_fro(out, want)
        print(f"[K1] {name} ({inst} instance): rel_fro {err:.2e} (bound {tol:.2g})", flush=True)
        check(inst == expect and out.dtype == x.dtype and err <= tol,
              f"K1 {name} ({inst} instance) rel_fro {err:.3e}")

    # times at the main path's first-step shape, the SM clock sampled
    # under the kernel's load
    work = c.clone()
    clk, clk_max = _sm_clocks(lambda: rec.update(
        ms=time_ms(lambda: gemm(a, b, c=work, alpha=-1.0, out=work), 10)))
    rec["plain_ms"] = time_ms(lambda: gemm_plain(a, b, c, alpha=-1.0), 3)
    rec["library_ms"] = time_ms(lambda: torch.addmm(c, a, b, alpha=-1.0), 3)
    flops = 2.0 * M * M * K
    nbytes = 4.0 * (M * K + K * M + 2 * M * M)
    _bound(rec, flops, nbytes)
    # the f32 peak scales with the SM clock: 132 SMs x 128 lanes x 2 flops
    at_clock = flops / (PEAK_F32_FLOPS * clk / clk_max) * 1e3
    print(f"[K1] times at {M}x{K}x{M}: kernel {rec['ms']:.3f} ms "
          f"({flops / rec['ms'] / 1e9:.1f} TFLOP/s), plain {rec['plain_ms']:.3f} ms, "
          f"torch.addmm {rec['library_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
          f"({rec['bound_by']}, {PEAK_F32_FLOPS / 1e12:g} TFLOP/s at {clk_max:.0f} MHz); "
          f"SM clock under the kernel {clk:.0f} MHz, bound at that clock {at_clock:.3f} ms",
          flush=True)
    del a, b, c, work
    torch.cuda.empty_cache()

    # the Cholesky path's calls: in place on the strided trailing view of
    # an (N, N) matrix, L10 contiguous and L10^T a contiguous copy
    for N, v, off in ((32768, 1024, 0), (4096, 256, 0), (4096, 256, 1280)):
        A = torch.rand((N, N), generator=gen, device=dev) * 2 - 1
        L10 = A[off + v:, off:off + v].contiguous()
        L10T = L10.T.contiguous()
        trail = A[off + v:, off + v:]
        want = gemm_plain(L10, L10T, trail, alpha=-1.0)
        top, left = A[:off + v].clone(), A[:, :off + v].clone()
        inst = gemm_instance(L10, L10T, trail, trail)
        gemm(L10, L10T, c=trail, alpha=-1.0, out=trail)
        torch.cuda.synchronize()
        err = rel_fro(trail, want)
        kept = torch.equal(A[:off + v], top) and torch.equal(A[:, :off + v], left)
        print(f"[K1] Cholesky trailing update N={N} v={v} off={off} (ld={N}, {inst} instance): "
              f"rel_fro {err:.2e} (bound {K1_TOL_F32:g}), max_abs "
              f"{float((trail - want).abs().max()):.2e}, rest of the matrix untouched {kept}",
              flush=True)
        check(inst == "tma" and err <= K1_TOL_F32 and kept,
              f"K1 Cholesky N={N} off={off} ({inst}) rel_fro {err:.3e}")
        del A, L10, L10T, trail, want, top, left
        torch.cuda.empty_cache()


def _bound(rec: dict, flops: float, nbytes: float) -> None:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    rec["bound_ms"] = max(t_ops, t_bytes)
    rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"


def _lu_block_flops(alive: torch.Tensor, w: int) -> float:
    """Flops this block's elimination does: per column, one division and
    2 * (w - j - 1) for each live non-pivot row."""
    live = int(alive.sum())
    total = 0.0
    for j in range(w):
        rows = max(live - 1, 0)
        total += rows * (1 + 2 * (w - j - 1))
        live = max(live - 1, 0)
    return total


def phase_k2(rec: dict) -> None:
    from conflux_tpu_torch.ops import hopper_kernels
    from conflux_tpu_torch.ops.hopper_kernels import (_PANEL_W, lu_block, lu_block_launch_count,
                                                      lu_block_plain, lu_block_route)

    gen = torch.Generator(device="cuda").manual_seed(2)
    w = _PANEL_W
    worst = 0.0

    def block(B: int, m: int) -> torch.Tensor:
        # the second column block of (m, 1024) panel chunks, a strided view
        # as panel_lu_pallas passes it
        chunk = torch.rand((B, m, 1024), generator=gen, device="cuda") * 2 - 1
        chunk[:, ::8, 128:256] += 2.0
        return chunk[:, :, w:2 * w]

    for m in (4096, 2048):
        blk = block(1, m)[0]
        for dead in (0.0, 0.25):
            alive = (torch.rand((m, 1), generator=gen, device="cuda") >= dead).to(torch.int32)
            out, al, piv = lu_block(blk, alive)
            out_p, al_p, piv_p = lu_block_plain(blk, alive)
            torch.cuda.synchronize()
            same_piv = torch.equal(piv, piv_p)
            same_alive = torch.equal(al, al_p)
            err = float((out - out_p).abs().max())
            close = torch.allclose(out, out_p, rtol=K2_TOL, atol=K2_TOL)
            worst = max(worst, err)
            print(f"[K2] ({m}, {w}) dead={dead:.2f}: piv equal {same_piv}, alive "
                  f"equal {same_alive}, max_abs {err:.2e} (allclose {K2_TOL:g}: "
                  f"{close})", flush=True)
            check(same_piv and same_alive and close, f"K2 ({m}, {w}) dead={dead}")

    # batches: each slot bitwise a B=1 launch on its block, on either route,
    # in one wave and (12 slots of clusters of 16, 7 at once) in two
    for B, m in ((8, 4096), (4, 2048), (12, 4096), (4, 8192)):
        blk = block(B, m)
        alive = (torch.rand((B, m, 1), generator=gen, device="cuda") >= 0.25).to(torch.int32)
        launches = lu_block_launch_count(m, B, blk.device)
        before = hopper_kernels.LAUNCHES["lu_block"]
        out, al, piv = lu_block(blk, alive)
        launched = hopper_kernels.LAUNCHES["lu_block"] - before
        alone = all(all(torch.equal(x, y) for x, y in zip((out[i], al[i], piv[i]),
                                                          lu_block(blk[i], alive[i])))
                    for i in range(B))
        plain_ok = True
        for i in (0, B - 1):
            out_p, al_p, piv_p = lu_block_plain(blk[i], alive[i])
            worst = max(worst, float((out[i] - out_p).abs().max()))
            plain_ok &= (torch.equal(piv[i], piv_p) and torch.equal(al[i], al_p)
                         and torch.allclose(out[i], out_p, rtol=K2_TOL, atol=K2_TOL))
        torch.cuda.synchronize()
        print(f"[K2] batched ({B}, {m}, {w}) dead=0.25: {launched} launch(es) on route "
              f"{lu_block_route(m, B, blk.device)} (predicted {launches}); every slot bitwise "
              f"a B=1 launch {alone}; slots 0 and {B - 1} against the plain version: pivots, "
              f"alive equal and allclose {plain_ok}", flush=True)
        check(alone and plain_ok and launched == launches, f"K2 batched ({B}, {m})")
    rec["max_abs_err"] = worst
    _k2_nan_blocks()

    # times at the main path's shapes: one block (a panel within 4096
    # rows), the 8 chunks of a tournament's first round, the 4 pairs of
    # its first tree level; the N=32768 cell's 8192-row chunks and its two
    # 2048-row tree rounds; the library factors the same batch (cuSOLVER)
    lib_was = torch.backends.cuda.preferred_linalg_library()
    for B, m in ((1, 4096), (8, 4096), (4, 2048), (4, 8192), (2, 2048), (1, 2048)):
        blk = block(B, m)
        ones = torch.ones((B, m, 1), dtype=torch.int32, device="cuda")
        x, al = (blk[0], ones[0]) if B == 1 else (blk, ones)
        ms = time_ms(lambda: lu_block(x, al), 20)
        torch.backends.cuda.preferred_linalg_library("cusolver")
        lib = time_ms(lambda: torch.linalg.lu_factor(x), 5)
        torch.backends.cuda.preferred_linalg_library(lib_was)
        r = {}
        _bound(r, B * _lu_block_flops(ones[0], w), B * 4.0 * (2 * m * w + 2 * m + w))
        line = (f"[K2] times at ({B}, {m}, {w}) on {lu_block_route(m, B, x.device)}: kernel "
                f"{ms:.3f} ms ({ms / B * 1e3:.1f} us a slot), torch.linalg.lu_factor {lib:.3f} "
                f"ms, bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
        if (B, m) == (8, 4096):  # the main path's largest launch goes in the kernels line
            plain = time_ms(lambda: lu_block_plain(x, al), 2)
            rec.update(ms=ms, plain_ms=plain, library_ms=lib, **r)
            line += f", plain {plain:.3f} ms"
        print(line, flush=True)


def _k2_nan_blocks() -> None:
    """K2's election meets NaN scores as `jnp.max` does (a NaN wins, the
    step records m, reads row m - 1 and kills no row), as its plain version:
    an all-zero (512, 128) block (column 1 turns NaN), a NaN column 0, one
    NaN in column 0; alone and as slot 2 of a batch of live random blocks,
    whose other slots keep the bits of a launch on their block alone."""
    import numpy as np

    from conflux_tpu_torch.ops.hopper_kernels import lu_block, lu_block_plain

    m = 512
    rng = np.random.default_rng(61)
    zero = np.zeros((m, 128), np.float32)
    nan_col = rng.uniform(-1, 1, (m, 128)).astype(np.float32)
    nan_col[:, 0] = np.nan
    one_nan = rng.uniform(-1, 1, (m, 128)).astype(np.float32)
    one_nan[300, 0] = np.nan
    gen = torch.Generator(device="cuda").manual_seed(62)
    batch = torch.rand((4, m, 128), generator=gen, device="cuda") * 2 - 1
    alive = torch.ones((4, m, 1), dtype=torch.int32, device="cuda")

    def same(got, want) -> bool:  # piv, alive equal; out's NaNs in place, the rest allclose
        return (torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
                and torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
                and torch.allclose(got[0], want[0], rtol=K2_TOL, atol=K2_TOL, equal_nan=True))

    for name, blk in (("all zero", zero), ("NaN column 0", nan_col), ("one NaN", one_nan)):
        blk = torch.from_numpy(blk).to("cuda")
        want = lu_block_plain(blk, alive[0])
        alone = same(lu_block(blk, alive[0]), want)
        batch[2] = blk
        out, al, piv = lu_block(batch, alive)
        slots = all(all(_same_bits(x, y) for x, y in zip((out[i], al[i], piv[i]),
                                                          lu_block(batch[i], alive[i])))
                    for i in range(4))
        in_batch = same((out[2], al[2], piv[2]), want)
        torch.cuda.synchronize()
        p = want[2][0]
        print(f"[K2] NaN election, {name} ({m}, 128): plain piv {p[:3].tolist()}... "
              f"({int((p == m).sum())} of 128 record m); kernel equal alone {alone}, in a batch "
              f"{in_batch}; every slot bitwise a B=1 launch {slots}", flush=True)
        check(alone and in_batch and slots, f"K2 NaN election, {name}")


def run_miniapp(argv: list[str], app: str = "conflux_miniapp",
                kernels: tuple = ("gemm", "lu_block")) -> tuple[list[str], dict]:
    """One run of miniapp `app` with every launch count set to 0 just
    before it; returns its output lines and the counts read just after,
    which must show each of `kernels` launched."""
    import importlib

    from conflux_tpu_torch.ops import hopper_kernels

    main = importlib.import_module(f"conflux_tpu_torch.cli.{app}").main
    tag = {"conflux_miniapp": "main", "cholesky_miniapp": "chol"}.get(app, "qr")
    buf = io.StringIO()
    hopper_kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    counts = dict(hopper_kernels.LAUNCHES)
    check(rc == 0, f"{app} {argv} returned {rc}")
    lines = buf.getvalue().splitlines()
    print(f"[{tag}] {' '.join(argv)}: {time.perf_counter() - t0:.1f} s wall", flush=True)
    for line in lines:
        if line.startswith(("_route_", "_result_", "_residual_", "_solve_residual_")):
            print(f"[{tag}]   {line}", flush=True)
    print(f"[{tag}]   launches: {counts} (warm-up + 1 timed factorization)", flush=True)
    check(all(counts[k] > 0 for k in kernels),
          f"a kernel of the {app} path never launched: {counts}")
    return lines, counts


def _field(lines: list[str], prefix: str) -> str:
    hits = [l for l in lines if l.startswith(prefix)]
    check(len(hits) >= 1, f"no {prefix} line")
    return hits[-1]


def _predicted_k2(N: int, v: int) -> int:
    """K2 launches of one LU factorization of an (N, N) matrix with panels
    v wide, as the panel family makes them (one batched factorization per
    tournament round, a launch per wave of slots)."""
    from conflux_tpu_torch.ops.blas import lu_block_launches

    return sum(lu_block_launches(N - k * v, v, torch.device("cuda")) for k in range(N // v))


def _only_tma(counts: dict, tag: str) -> None:
    print(f"[{tag}]   K1: {counts['gemm_tma']} of {counts['gemm']} launches on the TMA "
          "instance", flush=True)
    check(counts["gemm"] > 0 and counts["gemm_tma"] == counts["gemm"],
          f"the {tag} path ran K1's SIMT instance: {counts}")


def phase_main() -> dict:
    from conflux_tpu_torch.validation import residual_bound

    lines, counts = run_miniapp(["-N", "32768", "-b", "1024", "-r", "1", "--validate"])
    want = 2 * _predicted_k2(32768, 1024)  # warm-up + 1 timed factorization
    print(f"[main]   K2: {counts['lu_block']} launches, predicted {want} (800 a "
          "factorization; 2272 one tournament chunk at a time)", flush=True)
    check(counts["lu_block"] == want, f"N=32768 launched K2 {counts['lu_block']} times, not {want}")
    _only_tma(counts, "main")
    ms = float(_field(lines, "_result_").split(",")[8])
    res = float(_field(lines, "_residual_").split()[1])
    bar = residual_bound(32768, torch.float32)
    check(math.isfinite(res) and res <= bar, f"N=32768 residual {res:.3e} > {bar:.3e}")
    print(f"[main]   N=32768: {ms:.1f} ms per factorization = "
          f"{2 / 3 * 32768 ** 3 / ms / 1e9:.1f} TFLOP/s; residual {res:.3e} <= {bar:.3e}",
          flush=True)

    lines2, counts2 = run_miniapp(["-N", "8192", "-b", "1024", "-r", "1", "--validate",
                                   "--refine", "4"])
    want2 = 2 * _predicted_k2(8192, 1024)
    check(counts2["lu_block"] == want2, f"N=8192 launched K2 {counts2['lu_block']} times, "
          f"not {want2}")
    _only_tma(counts2, "main")
    res2 = float(_field(lines2, "_residual_").split()[1])
    bar2 = residual_bound(8192, torch.float32)
    check(math.isfinite(res2) and res2 <= bar2, f"N=8192 residual {res2:.3e}")
    check("PASS" in _field(lines2, "_solve_residual_"), "N=8192 solve residual not PASS")
    torch.cuda.empty_cache()
    return counts, ms


def _systems(B: int, n: int, seed: int, dtype=torch.float32) -> torch.Tensor:
    """The serve benchmark's matrix class (`bench_serve.py`): standard
    normal / sqrt(n) + 2 I, made on the host from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    return torch.from_numpy(A).to("cuda", dtype)


def _btrsm_bound(B: int, n: int, k: int, nb: int, bs: int, itemsize: int) -> dict:
    """K3's bound for one lower (or upper) solve: the bytes it must move
    are the strictly-triangular off-diagonal panels of T (it reads no
    other part of T), Dinv, the right-hand side read once and x written
    once; the operations are one (bs, bs) x (bs, k) product per block and
    the panels' downdates."""
    panel = sum(max(n - (j * bs + bs), 0) * min(bs, n - j * bs) for j in range(nb))
    r = {}
    _bound(r, B * 2.0 * (nb * bs * bs + panel) * k,
           B * (panel + 2.0 * n * k + nb * bs * bs) * itemsize)
    return r


def _lapack_pivots(perm: torch.Tensor) -> torch.Tensor:
    """LAPACK's pivots (1-based row swaps, in order) of the row order perm
    (A[perm] = L U), for `torch.linalg.lu_solve`."""
    import numpy as np

    P = perm.cpu().numpy()
    B, n = P.shape
    piv = np.empty((B, n), np.int32)
    for s in range(B):
        cur, pos = np.arange(n), np.arange(n)  # row at each position, position of each row
        for i in range(n):
            p = pos[P[s, i]]
            piv[s, i] = p + 1
            ri, rp = cur[i], cur[p]
            cur[i], cur[p] = rp, ri
            pos[rp], pos[ri] = i, p
    return torch.from_numpy(piv).to(perm.device)


def phase_k3(rec: dict) -> None:
    from conflux_tpu_torch.ops.batched_trsm import diag_block_inverses
    from conflux_tpu_torch.ops.hopper_kernels import (batched_chol, batched_lu, btrsm,
                                                      btrsm_pair, btrsm_pair_plain, btrsm_plain)

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    # the serving shapes, (32, 256, 256) and (32, 1024, 1024) with one
    # right-hand side per system, then 16 columns and a ragged n
    for n, k in ((256, 1), (1024, 1), (256, 16), (200, 16)):
        LU, perm, _ = batched_lu(_systems(32, n, n + k))  # a packed LU operand
        L, _ = batched_chol(_spd_systems(32, n, 300 + n + k))
        b = torch.randn((32, n, k), generator=gen, device="cuda")
        wA = torch.randn((32, n), generator=gen, device="cuda")
        Ds = {lower: diag_block_inverses(LU, lower=lower, unit_diagonal=lower)
              for lower in (True, False)}
        for lower in (True, False):
            got = btrsm(LU, Ds[lower], b, lower=lower)
            want = btrsm_plain(LU, Ds[lower], b, lower=lower)
            torch.cuda.synchronize()
            err = rel_fro(got, want)
            worst = max(worst, float((got - want).abs().max()))
            print(f"[K3] (32, {n}, {n}) k={k} {'lower unit' if lower else 'upper'}: "
                  f"rel_fro {err:.2e} (bound {K3_TOL:g})", flush=True)
            check(err <= K3_TOL, f"K3 n={n} k={k} lower={lower} rel_fro {err:.3e}")
        Dc = diag_block_inverses(L, lower=True)
        rounds = {"LU": (LU, Ds[True], Ds[False], perm, False),
                  "SPD": (L, Dc, None, None, True)}
        for name, (T, Dl, Du, p, tb) in rounds.items():
            x = btrsm_pair(T, Dl, Du, b, perm=p, trans_back=tb)
            xp, xsum, wAx = btrsm_pair(T, Dl, Du, b, perm=p, trans_back=tb, wA=wA)
            want, xs_p, wax_p = btrsm_pair_plain(T, Dl, Du, b, p, tb, wA)
            one = btrsm_pair(T[31:], Dl[31:], None if Du is None else Du[31:], b[31:],
                             perm=None if p is None else p[31:], trans_back=tb, wA=wA[31:])
            torch.cuda.synchronize()
            err = rel_fro(x, want)
            worst = max(worst, float((x - want).abs().max()))
            st_err = max(float(((xsum - xs_p).abs() / x.abs().sum(dim=(1, 2))).max()),
                         float(((wAx - wax_p).abs() / (wA * x[:, :, 0]).abs().sum(1)).max()))
            same = torch.equal(xp, x)
            alone = all(torch.equal(g[0], r) for g, r in zip(one, (x[31], xsum[31], wAx[31])))
            print(f"[K3] round {name} (32, {n}, {n}) k={k}: rel_fro {err:.2e} (bound "
                  f"{K3_TOL:g}); probe stats error {st_err:.2e} (bound {K3_STATS_TOL:g}); x bits "
                  f"kept with the probe {same}; slot 31 bitwise a B=1 launch {alone}",
                  flush=True)
            check(err <= K3_TOL and st_err <= K3_STATS_TOL and same and alone,
                  f"K3 round {name} n={n} k={k}")
        if n % 32:
            continue
        # times: one substitution, then each round beside its library call;
        # kernel and library call alike, the CUDA-event time of 20 calls of
        # the Python entry (the host's time included where the card waits
        # for it) and the device time of 20 calls captured in a CUDA graph
        D = Ds[True]
        ev, ms = _both_ms(lambda: btrsm(LU, D, b, lower=True))
        plain = time_ms(lambda: btrsm_plain(LU, D, b, lower=True), 5)
        lib, lib_g = _both_ms(lambda: torch.linalg.solve_triangular(
            LU, b, upper=False, unitriangular=True))
        r = _btrsm_bound(32, n, k, D.shape[1], D.shape[-1], LU.element_size())
        print(f"[K3] times at (32, {n}, {n}) k={k}, one substitution (lower unit), a call "
              f"(device): kernel {ev * 1e3:.1f} ({ms * 1e3:.1f}) us, plain {plain * 1e3:.1f} us, "
              f"torch.linalg.solve_triangular {lib * 1e3:.1f} ({lib_g * 1e3:.1f}) us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})", flush=True)
        pivots = _lapack_pivots(perm)
        # torch.cholesky_solve waits on the host inside (a CUDA graph
        # cannot capture it): its device time is not taken
        libs = {"LU": ("torch.linalg.lu_solve", lambda: torch.linalg.lu_solve(LU, pivots, b),
                       True),
                "SPD": ("torch.cholesky_solve", lambda: torch.cholesky_solve(b, L), False)}
        for name, (T, Dl, Du, p, tb) in rounds.items():
            lib_name, lib_fn, capturable = libs[name]
            agree = rel_fro(lib_fn(), btrsm_pair(T, Dl, Du, b, perm=p, trans_back=tb))
            check(agree <= 1e-4, f"K3 round {name}: {lib_name} disagrees ({agree:.2e})")
            ev, ms = _both_ms(lambda: btrsm_pair(T, Dl, Du, b, perm=p, trans_back=tb))
            ev_probe, ms_probe = _both_ms(
                lambda: btrsm_pair(T, Dl, Du, b, perm=p, trans_back=tb, wA=wA))
            plain = time_ms(lambda: btrsm_pair_plain(T, Dl, Du, b, p, tb), 5)
            lib, lib_g = _both_ms(lib_fn) if capturable else (time_ms(lib_fn, 20), None)
            r = _btrsm_bound(32, n, k, Dl.shape[1], Dl.shape[-1], T.element_size())
            r = {"bound_ms": 2 * r["bound_ms"], "bound_by": r["bound_by"]}  # two substitutions
            print(f"[K3] times at (32, {n}, {n}) k={k}, round {name}, a call (device): kernel "
                  f"{ev * 1e3:.1f} ({ms * 1e3:.1f}) us, with the probe stats {ev_probe * 1e3:.1f} "
                  f"({ms_probe * 1e3:.1f}) us, plain {plain * 1e3:.1f} us, {lib_name} "
                  f"{lib * 1e3:.1f} ({'not measured' if lib_g is None else f'{lib_g * 1e3:.1f}'}) "
                  f"us (agrees to {agree:.1e}), bound "
                  f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})", flush=True)
            if (n, k, name) == (256, 1, "LU"):  # serving (a)'s round goes in the kernels line
                rec.update(ms=ev, plain_ms=plain, library_ms=lib, **r)
    rec["max_abs_err"] = max(worst, _k3_any_width_and_n())


def _both_ms(fn) -> tuple[float, float]:
    """(CUDA-event time of a call of fn, its device time in a CUDA graph)."""
    return time_ms(fn, 20), graph_ms(fn, 20)


def _k3_any_width_and_n() -> float:
    """K3 beyond the serving shapes, against its plain versions: diagonal
    blocks 64 wide (ragged n=200; run as their 32-wide diagonal
    sub-blocks), and a round at n=20000 f32, whose x blocks do not fit
    shared memory (the instance that keeps them in global memory), with
    its time. Returns the largest absolute error."""
    from conflux_tpu_torch.ops.batched_trsm import blocked_trsm, diag_block_inverses
    from conflux_tpu_torch.ops.hopper_kernels import (btrsm, btrsm_pair, btrsm_pair_plain,
                                                      btrsm_plain)

    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    for B, n, bs in ((4, 200, 64), (1, 20000, 32)):
        # a well-conditioned packed LU: unit lower, upper with diagonal 2
        T = torch.randn((B, n, n), generator=gen, device="cuda") / n
        T.diagonal(dim1=-2, dim2=-1).add_(2.0)
        b = torch.randn((B, n, 1), generator=gen, device="cuda")
        perm = torch.stack([torch.randperm(n, generator=gen, device="cuda") for _ in range(B)])
        Dl = diag_block_inverses(T, lower=True, unit_diagonal=True, block_size=bs)
        Du = diag_block_inverses(T, lower=False, block_size=bs)
        got = {"round": btrsm_pair(T, Dl, Du, b, perm=perm)}
        want = {"round": btrsm_pair_plain(T, Dl, Du, b, perm)}
        if bs > 32:
            got["btrsm"] = btrsm(T, Du, b, lower=False)
            want["btrsm"] = btrsm_plain(T, Du, b, lower=False)
            got["blocked_trsm"] = blocked_trsm(T, b, lower=True, unit_diagonal=True,
                                               block_size=bs)
            want["blocked_trsm"] = btrsm_plain(T, Dl, b, lower=True)
        torch.cuda.synchronize()
        for name in got:
            err = rel_fro(got[name], want[name])
            worst = max(worst, float((got[name] - want[name]).abs().max()))
            print(f"[K3] {name} ({B}, {n}, {n}) k=1, blocks {bs} wide: rel_fro {err:.2e} "
                  f"(bound {K3_TOL:g})", flush=True)
            check(err <= K3_TOL, f"K3 {name} n={n} bs={bs} rel_fro {err:.3e}")
        if n > 10000:
            ms = time_ms(lambda: btrsm_pair(T, Dl, Du, b, perm=perm), 1)
            print(f"[K3] round ({B}, {n}, {n}) k=1 (x blocks in global memory): {ms:.1f} ms",
                  flush=True)
    return worst


def _lu_bound(B: int, m: int, itemsize: int) -> dict:
    """K4's bound from the JAX kernel's cost estimate
    (conflux_tpu/ops/pallas_factor.py:241-245), over the f32 peaks."""
    r = {}
    _bound(r, B * (2 * m ** 3 / 3 + 2 * m * m), B * (2 * m * m + 2 * m) * itemsize)
    return r


def _geometry(name: str, A: torch.Tensor) -> str:
    from conflux_tpu_torch.ops.hopper_kernels import batched_factor_geometry

    kb, cs, gp = batched_factor_geometry(name, A)
    return f"kb {kb}, cluster {cs}" + (", panel in global memory" if gp else "")


def phase_k4(rec: dict) -> None:
    from conflux_tpu_torch.ops.hopper_kernels import batched_lu, batched_lu_plain

    for B, n, dtype in ((32, 256, torch.float32), (32, 1024, torch.float32),
                        (8, 256, torch.float64), (4, 200, torch.float32),
                        (3, 1000, torch.float32)):
        A = _systems(B, n, 100 + n + B, dtype)
        w = torch.where(torch.rand(n, device="cuda") < 0.5, -1.0, 1.0).to(dtype)
        LU, perm, wa = batched_lu(A, w)
        LUp, permp, wap = batched_lu_plain(A, w)
        torch.cuda.synchronize()
        same_piv = torch.equal(perm, permp)
        err = float((LU - LUp).abs().max())
        wa_err = rel_fro(wa, wap)
        # slot i of a B=1 launch is slot i of the batch, bit for bit
        alone = all(torch.equal(batched_lu(A[i:i + 1], w)[0][0], LU[i])
                    for i in (0, B - 1))
        name = str(dtype).removeprefix("torch.")
        print(f"[K4] ({B}, {n}, {n}) {name}: pivots equal {same_piv}, max_abs {err:.2e} "
              f"(bound {K4_TOL[dtype]:g}), wA rel_fro {wa_err:.2e}, B=1 slots bitwise "
              f"{alone} ({_geometry('batched_lu', A)}; B=1: "
              f"{_geometry('batched_lu', A[:1])})", flush=True)
        check(same_piv and err <= K4_TOL[dtype] and wa_err <= K4_WA_TOL and alone,
              f"K4 ({B}, {n}, {n}) {name}")
        if (B, n, dtype) == (32, 256, torch.float32):
            rec["max_abs_err"] = err
        if dtype == torch.float32 and B == 32:
            ms = time_ms(lambda: batched_lu(A, w), 10)
            plain = time_ms(lambda: batched_lu_plain(A, w), 1)
            lib = time_ms(lambda: torch.linalg.lu_factor(A), 10)
            r = _lu_bound(B, n, 4)
            print(f"[K4] times at ({B}, {n}, {n}) ({_geometry('batched_lu', A)}): kernel "
                  f"{ms:.3f} ms, plain {plain:.3f} ms, torch.linalg.lu_factor {lib:.3f} ms, "
                  f"bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})", flush=True)
            if n == 256:
                rec.update(ms=ms, plain_ms=plain, library_ms=lib, **r)
        del A, LU, LUp
    # a NaN-poisoned slot comes out non-finite alone; its neighbours keep
    # their bits and no pivot leaves the range
    A = _systems(32, 256, 7)
    bad = A.clone()
    bad[5] = float("nan")
    LU, perm, _ = batched_lu(A)
    LUn, permn, _ = batched_lu(bad)
    LUp, permp, _ = batched_lu_plain(bad)
    keep = [i for i in range(32) if i != 5]
    ok = (torch.equal(LUn[keep], LU[keep]) and torch.equal(permn[keep], perm[keep])
          and not bool(torch.isfinite(LUn[5]).any()) and torch.equal(permn, permp)
          and bool(((permn[5] >= 0) & (permn[5] < 256)).all()))
    print(f"[K4] NaN slot: poisoned alone, neighbours bitwise, pivots equal: {ok}", flush=True)
    check(ok, "K4 NaN slot")


def _lu_residuals(A: torch.Tensor, LU: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """||A[perm] - L U||_F / ||A||_F per system, in float64 on the card."""
    n = LU.shape[-1]
    LUd = LU.double()
    L = torch.tril(LUd, -1) + torch.eye(n, dtype=torch.float64, device=LU.device)
    Ap = torch.gather(A.double(), 1, perm[:, :, None].expand(-1, -1, n))
    R = Ap - L @ torch.triu(LUd)
    return torch.linalg.norm(R, dim=(1, 2)) / torch.linalg.norm(A.double(), dim=(1, 2))


def _serve_counts(fn):
    """Run fn with every launch count set to 0 just before it; return its
    result and the counts read just after."""
    from conflux_tpu_torch.ops import hopper_kernels

    hopper_kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(hopper_kernels.LAUNCHES)


def phase_serve_a() -> dict:
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.validation import residual_bound

    B, n, rounds = 32, 256, 16
    serve.clear_plans()
    plan = serve.FactorPlan.create((B, n, n), torch.float32, v=128)
    A = _systems(B, n, 0)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rhs = [torch.randn((B, n), generator=gen, device="cuda") for _ in range(rounds)]

    def drive():
        s = plan.factor(A)
        xs = [s.solve(b) for b in rhs]
        checked = [s.solve_checked(b) for b in rhs]
        return s, xs, checked

    (s, xs, checked), counts = _serve_counts(drive)
    print(f"[serve a] plan {plan.key.shape} {plan.key.substitution}: launches {counts}",
          flush=True)
    check(counts["batched_lu"] > 0 and counts["btrsm"] == 2 * rounds,
          f"serving (a) did not launch K4, and K3 once per round: {counts}")
    LU, _Dl, _Du, perm = s.factors
    res = float(_lu_residuals(A, LU, perm).max())
    bar = residual_bound(n, torch.float32)
    worst = max(float((torch.einsum("bij,bj->bi", A, x) - b).abs().max())
                for x, b in zip(xs, rhs))
    verdicts = torch.stack([v for _x, v in checked])
    same = all(torch.equal(xc, x) for (xc, _v), x in zip(checked, xs))
    print(f"[serve a] factor residual max {res:.3e} (bar {bar:.3e}); max |A x - b| "
          f"{worst:.3e} (bar {SOLVE_TOL:g}); checked verdicts finite min "
          f"{float(verdicts[:, 0].min()):g}, residual max {float(verdicts[:, 1].max()):.3e}; "
          f"checked answers equal the plain ones {same}", flush=True)
    check(res <= bar, f"serving (a) factor residual {res:.3e}")
    check(worst < SOLVE_TOL, f"serving (a) max |A x - b| {worst:.3e}")
    check(bool((verdicts[:, 0] == 1.0).all()) and float(verdicts[:, 1].max()) < SOLVE_TOL,
          "serving (a) checked verdicts")
    check(same, "serving (a) solve_checked answers differ from solve")
    fac_ms = time_ms(lambda: plan.factor(A), 5)
    t0 = time.perf_counter()
    for b in rhs:
        s.solve(b)
    torch.cuda.synchronize()
    solve_us = (time.perf_counter() - t0) / rounds * 1e6
    t0 = time.perf_counter()
    for b in rhs:
        s.solve_checked(b)
    torch.cuda.synchronize()
    checked_us = (time.perf_counter() - t0) / rounds * 1e6
    print(f"[serve a] {fac_ms:.3f} ms per factor (CUDA events, 5 calls); {solve_us:.1f} us "
          f"per solve round, {checked_us:.1f} us per checked round (host clock, {rounds} "
          "rounds, one synchronize)", flush=True)
    return counts


def phase_serve_b() -> dict:
    from conflux_tpu_torch import serve

    bb, n = 32, 1024
    serve.clear_plans()
    plan = serve.FactorPlan.create((n, n), torch.float32, v=128)
    A = _systems(bb, n, 1)
    (F, wA, verdict), counts = _serve_counts(lambda: plan._factor_health_fn(bb)(A))
    print(f"[serve b] plan {plan.key.shape}, bucket {bb}: launches {counts}", flush=True)
    check(counts["batched_lu"] > 0 and counts["btrsm"] == 1,
          f"serving (b) did not launch K4, and K3 once: {counts}")
    # HealthPolicy's default bar in the JAX package: 1e4 eps sqrt(N)
    limit = 1e4 * torch.finfo(torch.float32).eps * math.sqrt(n)
    clean = bool((verdict[0] == 1.0).all()) and float(verdict[1].max()) <= limit
    s = plan.factor(A[0])
    bitwise = all(torch.equal(got[0], ref) for got, ref in zip(F, s.factors))
    print(f"[serve b] verdicts clean {clean} (residual max {float(verdict[1].max()):.3e}, "
          f"limit {limit:.3e}); plan.factor slot 0 bitwise the bucket's {bitwise}",
          flush=True)
    check(clean, "serving (b) verdicts")
    check(bitwise, "serving (b) plan.factor is not bitwise slot 0 of the bucket")
    ms = time_ms(lambda: plan._factor_health_fn(bb)(A), 3)
    print(f"[serve b] {ms:.3f} ms per coalesced checked factor of {bb} systems", flush=True)
    del F, wA, s
    return counts


def _spd_systems(B: int, n: int, seed: int, dtype=torch.float32) -> torch.Tensor:
    """The JAX serve tests' SPD class: M M^T + I with M = normal / sqrt(n)
    + 2 I (M from a seed on the host, the product in float64 on the card)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    M = torch.from_numpy(rng.standard_normal((B, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
                         ).to("cuda")
    return (M @ M.mT + torch.eye(n, dtype=torch.float64, device="cuda")).to(dtype)


def _chol_bound(B: int, m: int, itemsize: int) -> dict:
    """K5's bound from the JAX kernel's cost estimate
    (conflux_tpu/ops/pallas_factor.py:278-282), over the f32 peaks."""
    r = {}
    _bound(r, B * (m ** 3 / 3 + 2 * m * m), B * (2 * m * m + 2 * m) * itemsize)
    return r


def _chol_division_floor_ms(B: int, n: int) -> float:
    """K5's floor from its arithmetic as the kernel must do it: each of the
    B * sum_j (n - j - 1)^2 updates is a product, an IEEE division and a
    difference, each rounded. The cheapest exact division is a product by
    the column's reciprocal and two FMA corrections, so an update issues
    7 float32 instructions, at the peak's 67e12 / 2 a second."""
    updates = B * sum((n - j - 1) ** 2 for j in range(n))
    return updates * 7 / (PEAK_F32_FLOPS / 2) * 1e3


def _same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Equal values, and NaNs in the same places."""
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny])


def phase_k5(rec: dict) -> None:
    from conflux_tpu_torch.ops.hopper_kernels import batched_chol, batched_chol_plain

    for B, n, dtype in ((32, 256, torch.float32), (32, 1024, torch.float32),
                        (8, 256, torch.float64), (4, 200, torch.float32),
                        (3, 1000, torch.float32)):
        A = _spd_systems(B, n, 200 + n + B, dtype)
        w = torch.where(torch.rand(n, device="cuda") < 0.5, -1.0, 1.0).to(dtype)
        L, wa = batched_chol(A, w)
        Lp, wap = batched_chol_plain(A, w)
        torch.cuda.synchronize()
        err = float((L - Lp).abs().max())
        wa_err = rel_fro(wa, wap)
        upper0 = not bool(torch.triu(L, 1).any())
        alone = all(torch.equal(batched_chol(A[i:i + 1], w)[0][0], L[i]) for i in (0, B - 1))
        name = str(dtype).removeprefix("torch.")
        print(f"[K5] ({B}, {n}, {n}) {name}: max_abs {err:.2e} (bound {K5_TOL:g}), strict "
              f"upper zero {upper0}, wA rel_fro {wa_err:.2e}, B=1 slots bitwise {alone} "
              f"({_geometry('batched_chol', A)}; B=1: {_geometry('batched_chol', A[:1])})",
              flush=True)
        check(err <= K5_TOL and upper0 and wa_err <= K5_WA_TOL and alone,
              f"K5 ({B}, {n}, {n}) {name}")
        if (B, n, dtype) == (32, 256, torch.float32):
            rec["max_abs_err"] = err
        if dtype == torch.float32 and B == 32:
            ms = time_ms(lambda: batched_chol(A, w), 10 if n == 256 else 3)
            plain = time_ms(lambda: batched_chol_plain(A, w), 1)
            lib = time_ms(lambda: torch.linalg.cholesky(A), 10)
            r = _chol_bound(B, n, 4)
            print(f"[K5] times at ({B}, {n}, {n}) ({_geometry('batched_chol', A)}): kernel "
                  f"{ms:.3f} ms, plain {plain:.3f} ms, torch.linalg.cholesky {lib:.3f} ms, "
                  f"bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}; the IEEE division "
                  f"floor {_chol_division_floor_ms(B, n):.3f} ms)", flush=True)
            if n == 256:
                rec.update(ms=ms, plain_ms=plain, library_ms=lib, **r)
        del A, L, Lp
    # slots that are not positive definite come out NaN alone, as in the
    # plain version; the neighbours keep their bits
    A = _spd_systems(32, 256, 8)
    bad = A.clone()
    bad[5] = -bad[5]
    bad[9, 100, 100] = -50.0
    L, _ = batched_chol(A)
    Ln, _ = batched_chol(bad)
    Lp, _ = batched_chol_plain(bad)
    keep = [i for i in range(32) if i not in (5, 9)]
    ok = (torch.equal(Ln[keep], L[keep]) and bool(torch.isnan(Ln[5]).any())
          and bool(torch.isnan(Ln[9]).any()) and _same_bits(Ln, Lp))
    print(f"[K5] non-SPD slots: NaN alone, neighbours bitwise, equal to the plain version: "
          f"{ok}", flush=True)
    check(ok, "K5 non-SPD slots")


def _chol_residuals(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """||A - L L^T||_F / ||A||_F per system, in float64 on the card."""
    Ld = torch.tril(L.double())
    R = A.double() - Ld @ Ld.mT
    return torch.linalg.norm(R, dim=(1, 2)) / torch.linalg.norm(A.double(), dim=(1, 2))


def phase_serve_c() -> dict:
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.validation import residual_bound

    B, n, rounds = 32, 256, 16
    serve.clear_plans()
    plan = serve.FactorPlan.create((B, n, n), torch.float32, v=128, kind="chol")
    A = _spd_systems(B, n, 10)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rhs = [torch.randn((B, n), generator=gen, device="cuda") for _ in range(rounds)]

    def drive():
        s = plan.factor(A)
        xs = [s.solve(b) for b in rhs]
        checked = [s.solve_checked(b) for b in rhs]
        return s, xs, checked

    (s, xs, checked), counts = _serve_counts(drive)
    print(f"[serve c] plan {plan.key.shape} kind={plan.key.kind} {plan.key.substitution}: "
          f"launches {counts}", flush=True)
    check(counts["batched_chol"] == 1 and counts["btrsm"] == 2 * rounds,
          f"serving (c) did not launch K5 once and K3 once per round: {counts}")
    L, _Dl = s.factors
    res = float(_chol_residuals(A, L).max())
    bar = residual_bound(n, torch.float32)
    worst = max(float((torch.einsum("bij,bj->bi", A, x) - b).abs().max())
                for x, b in zip(xs, rhs))
    verdicts = torch.stack([v for _x, v in checked])
    same = all(torch.equal(xc, x) for (xc, _v), x in zip(checked, xs))
    print(f"[serve c] factor residual max {res:.3e} (bar {bar:.3e}); max |A x - b| "
          f"{worst:.3e} (bar {SOLVE_TOL:g}); checked verdicts finite min "
          f"{float(verdicts[:, 0].min()):g}, residual max {float(verdicts[:, 1].max()):.3e}; "
          f"checked answers equal the plain ones {same}", flush=True)
    check(res <= bar, f"serving (c) factor residual {res:.3e}")
    check(worst < SOLVE_TOL, f"serving (c) max |A x - b| {worst:.3e}")
    check(bool((verdicts[:, 0] == 1.0).all()) and float(verdicts[:, 1].max()) < SOLVE_TOL,
          "serving (c) checked verdicts")
    check(same, "serving (c) solve_checked answers differ from solve")
    fac_ms = time_ms(lambda: plan.factor(A), 5)
    t0 = time.perf_counter()
    for b in rhs:
        s.solve(b)
    torch.cuda.synchronize()
    solve_us = (time.perf_counter() - t0) / rounds * 1e6
    t0 = time.perf_counter()
    for b in rhs:
        s.solve_checked(b)
    torch.cuda.synchronize()
    checked_us = (time.perf_counter() - t0) / rounds * 1e6
    print(f"[serve c] {fac_ms:.3f} ms per factor (CUDA events, 5 calls); {solve_us:.1f} us "
          f"per solve round, {checked_us:.1f} us per checked round (host clock, {rounds} "
          "rounds, one synchronize)", flush=True)
    return counts


def phase_serve_d() -> dict:
    from conflux_tpu_torch import serve

    bb, n = 32, 1024
    serve.clear_plans()
    plan = serve.FactorPlan.create((n, n), torch.float32, v=128, kind="chol")
    A = _spd_systems(bb, n, 11)
    (F, wA, verdict), counts = _serve_counts(lambda: plan._factor_health_fn(bb)(A))
    print(f"[serve d] plan {plan.key.shape} kind={plan.key.kind}, bucket {bb}: launches "
          f"{counts}", flush=True)
    check(counts["batched_chol"] == 1 and counts["btrsm"] == 1,
          f"serving (d) did not launch K5 once and K3 once: {counts}")
    limit = 1e4 * torch.finfo(torch.float32).eps * math.sqrt(n)
    clean = bool((verdict[0] == 1.0).all()) and float(verdict[1].max()) <= limit
    s = plan.factor(A[0])
    bitwise = all(torch.equal(got[0], ref) for got, ref in zip(F, s.factors))
    print(f"[serve d] verdicts clean {clean} (residual max {float(verdict[1].max()):.3e}, "
          f"limit {limit:.3e}); plan.factor slot 0 bitwise the bucket's {bitwise}",
          flush=True)
    check(clean, "serving (d) verdicts")
    check(bitwise, "serving (d) plan.factor is not bitwise slot 0 of the bucket")
    ms = time_ms(lambda: plan._factor_health_fn(bb)(A), 3)
    print(f"[serve d] {ms:.3f} ms per coalesced checked factor of {bb} systems", flush=True)
    del F, wA, s
    return counts


def phase_chol_main() -> dict:
    from conflux_tpu_torch.validation import residual_bound

    lines, counts = run_miniapp(["--dim", "32768", "--tile", "1024", "--run", "1",
                                 "--validate"], app="cholesky_miniapp", kernels=("gemm",))
    _only_tma(counts, "chol")
    ms = float(_field(lines, "_result_").split(",")[8])
    res = float(_field(lines, "_residual_").split()[1])
    bar = residual_bound(32768, torch.float32)
    check(math.isfinite(res) and res <= bar, f"Cholesky N=32768 residual {res:.3e} > {bar:.3e}")
    print(f"[chol]   N=32768: {ms:.1f} ms per factorization = "
          f"{32768 ** 3 / 3 / ms / 1e9:.1f} TFLOP/s (N^3/3); residual {res:.3e} <= {bar:.3e}",
          flush=True)
    torch.cuda.empty_cache()
    lines2, counts2 = run_miniapp(["--dim", "4096", "--tile", "256", "--run", "1",
                                   "--validate", "--refine", "4"],
                                  app="cholesky_miniapp", kernels=("gemm",))
    _only_tma(counts2, "chol")
    res2 = float(_field(lines2, "_residual_").split()[1])
    bar2 = residual_bound(4096, torch.float32)
    check(math.isfinite(res2) and res2 <= bar2, f"Cholesky N=4096 residual {res2:.3e}")
    check("PASS" in _field(lines2, "_solve_residual_"), "Cholesky N=4096 solve residual "
          "not below 1e-6")
    return counts


# ----------------------------------------------------------------------- #
# the library routes (backend "xla", panel algos "partial" / "tournament" /
# "auto"), float64, the plans outside the batched factor kernels' gate and
# the solver API
# ----------------------------------------------------------------------- #

# H100 SXM float64 peak on the tensor cores (NVIDIA data sheet; 34e12
# outside them): DGEMM, the bulk of a float64 factorization, runs there
PEAK_F64_FLOPS = 67e12
SOLVE_RESIDUAL_BAR = 1e-6  # the --refine bar of the miniapps (PERF.md section 2)


@contextlib.contextmanager
def _library_route():
    """The registry on the JAX package's default route, xla / auto, and
    back to the port's kernel / kernel after."""
    from conflux_tpu_torch.ops import blas

    blas.set_backend("xla")
    blas.set_panel_algo("auto")
    try:
        yield
    finally:
        blas.set_backend("kernel")
        blas.set_panel_algo("kernel")


def _no_kernel(counts: dict, tag: str) -> None:
    """The library route runs no kernel of the port: K1..K5 all at 0."""
    check(all(v == 0 for v in counts.values()), f"{tag} launched a kernel: {counts}")


def phase_l64() -> dict:
    """(L64) BASELINE config #1 and (L64-full) the same route at N=32768."""
    from conflux_tpu_torch.ops import blas
    from conflux_tpu_torch.validation import residual_bound

    lines, counts = run_miniapp(["-N", "2048", "-b", "128", "-r", "1", "--dtype", "float64",
                                 "--validate", "--refine", "2"], kernels=())
    _no_kernel(counts, "L64")
    check(_field(lines, "_route_") == "_route_ backend=xla panel_algo=auto (float64)",
          "L64 route line")
    ms = float(_field(lines, "_result_").split(",")[8])
    res = float(_field(lines, "_residual_").split()[1])
    bar = residual_bound(2048, torch.float64)
    solve = _field(lines, "_solve_residual_")
    check(math.isfinite(res) and res <= bar and "PASS" in solve,
          f"L64 residual {res:.3e} (bar {bar:.3e}), {solve}")
    print(f"[L64] BASELINE config #1 (N=2048 b=128 float64, 1x1x1): {ms:.3f} ms per "
          f"factorization; residual {res:.3e} <= {bar:.3e}; {solve}", flush=True)
    torch.cuda.empty_cache()

    lines, counts = run_miniapp(["-N", "32768", "-b", "1024", "-r", "1", "--dtype", "float64",
                                 "--validate"], kernels=())
    _no_kernel(counts, "L64-full")
    ms_full = float(_field(lines, "_result_").split(",")[8])
    res = float(_field(lines, "_residual_").split()[1])
    bar = residual_bound(32768, torch.float64)
    check(math.isfinite(res) and res <= bar, f"L64-full residual {res:.3e} > {bar:.3e}")
    rate = 2 / 3 * 32768 ** 3 / (ms_full * 1e-3)
    print(f"[L64-full] N=32768 b=1024 float64: {ms_full:.1f} ms per factorization = "
          f"{rate / 1e12:.2f} TFLOP/s, {100 * rate / PEAK_F64_FLOPS:.1f}% of the "
          f"{PEAK_F64_FLOPS / 1e12:g} TFLOP/s float64 peak; residual {res:.3e} <= {bar:.3e}",
          flush=True)
    torch.cuda.empty_cache()
    # one round of the library tournament at this run's first panel, and the
    # host conversion of the library LU's pivots (one host copy a call)
    gen = torch.Generator(device="cuda").manual_seed(9)
    chunks = torch.randn((8, 4096, 1024), generator=gen, device="cuda", dtype=torch.float64)
    lib_was = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library(blas._library_lu_backend(chunks.shape))
    round_ms = time_ms(lambda: torch.linalg.lu_factor_ex(chunks), 3)
    torch.backends.cuda.preferred_linalg_library(lib_was)
    lu_round_ms = time_ms(lambda: blas._library_lu(chunks), 3)
    piv = torch.linalg.lu_factor_ex(chunks[0])[1]
    conv_ms = time_ms(lambda: blas._swaps_to_perm(piv, 32768), 10)
    panel = torch.randn((32768, 1024), generator=gen, device="cuda", dtype=torch.float64)
    tw_ms = time_ms(lambda: blas.tournament_winners(panel, use_pallas=False), 3)
    print(f"[L64-full] library tournament at the first panel (32768, 1024) float64: "
          f"chunk round lu_factor_ex (8, 4096, 1024) {round_ms:.2f} ms, with the pivots' "
          f"conversion {lu_round_ms:.2f} ms; one conversion of 1024 pivots to a 32768-row "
          f"permutation {conv_ms:.3f} ms (host); whole election {tw_ms:.2f} ms", flush=True)
    del chunks, panel
    # a batch of panels taller than MAGMA's batched limit: factored, and
    # nothing printed to the process's stdout (MAGMA's banner would be)
    tall = torch.randn((16, 4096, 256), generator=gen, device="cuda", dtype=torch.float64)
    printed: list = []
    with _stdout_fd(printed):
        LU, perm = blas._library_lu(tall)
        torch.cuda.synchronize()
    L = torch.tril(LU, -1) + torch.eye(4096, 256, dtype=LU.dtype, device=LU.device)
    R = torch.gather(tall, 1, perm[:, :, None].expand(-1, -1, 256)) - L @ torch.triu(LU[:, :256])
    res = float((torch.linalg.norm(R, dim=(1, 2)) / torch.linalg.norm(tall, dim=(1, 2))).max())
    bar = residual_bound(4096, torch.float64)
    print(f"[L64-full] library LU of (16, 4096, 256) float64 panels: {len(printed[0])} bytes "
          f"on stdout; residual {res:.2e} <= {bar:.2e}", flush=True)
    check(printed[0] == "", f"the library LU printed to stdout: {printed[0][:200]!r}")
    check(res <= bar, f"library LU of (16, 4096, 256) residual {res:.3e}")
    del L, R
    del tall, LU, perm
    torch.cuda.empty_cache()
    return {"ms": ms, "full_ms": ms_full}


def phase_lxla32(kernel_ms: float) -> None:
    """(Lxla32) the float32 library route at N=32768 v=1024 through the
    Python API, beside the kernel route's time of phase 5."""
    import numpy as np

    from conflux_tpu_torch.lu.single import lu_factor_blocked
    from conflux_tpu_torch.ops import hopper_kernels
    from conflux_tpu_torch.validation import lu_residual_device, make_test_matrix, residual_bound

    A = torch.from_numpy(make_test_matrix(32768, 32768, dtype=np.float32)).cuda()
    hopper_kernels.reset_launches()
    LU, perm = lu_factor_blocked(A, 1024, backend="xla", panel_algo="auto")  # warm-up
    del LU, perm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    LU, perm = lu_factor_blocked(A, 1024, backend="xla", panel_algo="auto")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _no_kernel(dict(hopper_kernels.LAUNCHES), "Lxla32")
    res = lu_residual_device(A, LU, perm)
    bar = residual_bound(32768, torch.float32)
    check(math.isfinite(res) and res <= bar, f"Lxla32 residual {res:.3e} > {bar:.3e}")
    print(f"[Lxla32] N=32768 v=1024 float32, backend xla / panel algo auto: {ms:.1f} ms per "
          f"factorization = {2 / 3 * 32768 ** 3 / ms / 1e9:.1f} TFLOP/s (host clock, one "
          f"synchronize), beside the kernel route's {kernel_ms:.1f} ms (phase 5); residual "
          f"{res:.3e} <= {bar:.3e}", flush=True)
    del A, LU, perm
    torch.cuda.empty_cache()


def phase_c64() -> None:
    """(C64) the Cholesky miniapp at float64, N=32768, and a complex128
    HPD Cholesky on backend xla at N=2048."""
    from conflux_tpu_torch.cholesky import cholesky_blocked
    from conflux_tpu_torch.validation import make_hpd_matrix, residual_bound

    lines, counts = run_miniapp(["--dim", "32768", "--tile", "1024", "--run", "1",
                                 "--dtype", "float64", "--validate"], app="cholesky_miniapp",
                                kernels=())
    _no_kernel(counts, "C64")
    ms = float(_field(lines, "_result_").split(",")[8])
    res = float(_field(lines, "_residual_").split()[1])
    bar = residual_bound(32768, torch.float64)
    check(math.isfinite(res) and res <= bar, f"C64 residual {res:.3e} > {bar:.3e}")
    rate = 32768 ** 3 / 3 / (ms * 1e-3)
    print(f"[C64] Cholesky N=32768 tile 1024 float64: {ms:.1f} ms per factorization = "
          f"{rate / 1e12:.2f} TFLOP/s (N^3/3), {100 * rate / PEAK_F64_FLOPS:.1f}% of the "
          f"float64 peak; residual {res:.3e} <= {bar:.3e}", flush=True)
    torch.cuda.empty_cache()
    n = 2048
    A = make_hpd_matrix(n, device="cuda")
    L = cholesky_blocked(A, 128, backend="xla")
    ms_c = time_ms(lambda: cholesky_blocked(A, 128, backend="xla"), 3)
    res_c = float(torch.linalg.norm(L @ L.mH - A) / torch.linalg.norm(A))
    bar_c = residual_bound(n, torch.float64)
    check(math.isfinite(res_c) and res_c <= bar_c, f"complex HPD residual {res_c:.3e}")
    print(f"[C64] complex128 HPD Cholesky N={n} tile 128, backend xla: {ms_c:.2f} ms; "
          f"||A - L L^H||_F / ||A||_F {res_c:.3e} <= {bar_c:.3e}", flush=True)
    torch.cuda.empty_cache()


def _rounds(s, rhs, checked: bool) -> float:
    """Host microseconds per solve round of session s over rhs (one
    synchronize at the end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in rhs:
        (s.solve_checked if checked else s.solve)(b)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(rhs) * 1e6


def _library_lu_split(A: torch.Tensor, v: int) -> None:
    """Time apart the two parts of each superstep's library LU of the
    batched factor of A (B, n, n): `lu_factor_ex` of the (B, n - k v, v)
    panels on the backend the route picks (CUDA events, median of 5 calls)
    and the pivots' conversion to a permutation (host clock around the
    call, its device-to-host copy included; median of 5)."""
    import statistics

    from conflux_tpu_torch.ops import blas

    B, n = A.shape[:2]
    parts = []
    for k in range(n // v):
        P = A[:, k * v:, k * v:k * v + v].contiguous()
        lib = blas._library_lu_backend(P.shape)
        was = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library(lib)
        lu = statistics.median(time_ms(lambda: torch.linalg.lu_factor_ex(P), 1) for _ in range(5))
        piv = torch.linalg.lu_factor_ex(P)[1]
        torch.backends.cuda.preferred_linalg_library(was)
        conv = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blas._swaps_to_perm(piv, P.shape[1])
            torch.cuda.synchronize()
            conv.append((time.perf_counter() - t0) * 1e3)
        parts.append((tuple(P.shape), lib, lu, statistics.median(conv)))
    lu_sum, conv_sum = sum(p[2] for p in parts), sum(p[3] for p in parts)
    steps = "; ".join(f"{shape} {lib}: LU {lu:.3f} ms, conversion {cv:.3f} ms"
                      for shape, lib, lu, cv in parts)
    print(f"[serve e] the factor's library LU by superstep: {steps}; in all LU {lu_sum:.3f} ms, "
          f"conversion {conv_sum:.3f} ms", flush=True)


def phase_serve_e() -> dict:
    """(e) serving on the library route: a backend="xla" f32 LU plan at
    (32, 1024, 1024), v=256; then a poisoned slot of an xla SPD plan."""
    from conflux_tpu_torch import serve

    B, n, rounds = 32, 1024, 16
    limit = 1e4 * torch.finfo(torch.float32).eps * math.sqrt(n)  # JAX HealthPolicy default
    with _library_route():
        serve.clear_plans()
        plan = serve.FactorPlan.create((B, n, n), torch.float32, v=256, backend="xla")
        check(plan.key.backend == "xla" and plan.key.panel_algo == "auto", f"(e) {plan.key}")
        A = _systems(B, n, 20)
        gen = torch.Generator(device="cuda").manual_seed(6)
        rhs = [torch.randn((B, n), generator=gen, device="cuda") for _ in range(rounds)]

        def drive():
            s = plan.factor(A)
            F, _wA, verdict = plan._factor_health_fn(1)(A[None])
            xs = [s.solve(b) for b in rhs]
            checked = [s.solve_checked(b) for b in rhs]
            return s, verdict, xs, checked

        printed: list = []
        with _stdout_fd(printed):
            (s, verdict, xs, checked), counts = _serve_counts(drive)
        print(f"[serve e] plan {plan.key.shape} backend xla / auto, v=256: launches {counts}; "
              f"{len(printed[0])} bytes on stdout", flush=True)
        check(printed[0] == "", f"serving (e) printed to stdout: {printed[0][:200]!r}")
        check(counts["btrsm"] == 2 * rounds + 1 and counts["batched_lu"] == 0
              and counts["gemm"] == 0 and counts["lu_block"] == 0,
              f"serving (e) is not one K3 launch a round (and one for the lane): {counts}")
        worst = max(float((torch.einsum("bij,bj->bi", A, x) - b).abs().max())
                    for x, b in zip(xs, rhs))
        verdicts = torch.stack([v for _x, v in checked])
        lane_clean = bool((verdict[0] == 1.0).all()) and float(verdict[1].max()) <= limit
        print(f"[serve e] max |A x - b| {worst:.3e} (bar {SOLVE_TOL:g}); checked verdicts "
              f"finite min {float(verdicts[:, 0].min()):g}, residual max "
              f"{float(verdicts[:, 1].max()):.3e}; factor lane verdict clean {lane_clean} "
              f"(residual {float(verdict[1].max()):.3e}, limit {limit:.3e})", flush=True)
        check(worst < SOLVE_TOL, f"serving (e) max |A x - b| {worst:.3e}")
        check(bool((verdicts[:, 0] == 1.0).all()) and float(verdicts[:, 1].max()) < SOLVE_TOL,
              "serving (e) checked verdicts")
        check(lane_clean, "serving (e) factor lane verdict")
        fac_ms = time_ms(lambda: plan.factor(A), 3)
        lane_ms = time_ms(lambda: plan._factor_health_fn(1)(A[None]), 3)
        solve_us, checked_us = _rounds(s, rhs, False), _rounds(s, rhs, True)
        print(f"[serve e] {fac_ms:.3f} ms per factor, {lane_ms:.3f} ms per coalesced checked "
              f"factor (CUDA events, 3 calls); {solve_us:.1f} us per solve round, "
              f"{checked_us:.1f} us per checked round (host clock, {rounds} rounds)", flush=True)
        _library_lu_split(A, 256)
        del s, xs, checked
        # a non-SPD slot of an xla SPD plan's bucket: NaN, and flagged alone
        serve.clear_plans()
        spd = serve.FactorPlan.create((256, 256), torch.float32, v=64, backend="xla",
                                      kind="chol")
        S = _spd_systems(4, 256, 21)
        S[2, 7, 7] = -1e3
        F, _wA, v = spd._factor_health_fn(4)(S)
        healthy = (v[0] >= 0.5) & (v[1] <= 1e4 * torch.finfo(torch.float32).eps * 16)
        poisoned = bool(torch.isnan(F[0][2]).any()) and not bool(healthy[2])
        others = bool(healthy[[0, 1, 3]].all()) and bool(torch.isfinite(F[0][[0, 1, 3]]).all())
        print(f"[serve e] xla SPD plan, a non-SPD slot of 4: NaN and flagged {poisoned}, the "
              f"others clean {others}", flush=True)
        check(poisoned and others, "serving (e) poisoned SPD slot")
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def _stdout_fd(box: list):
    """Whatever is written to file descriptor 1 inside the block (a C
    library's printf goes there, past Python's sys.stdout) is appended to
    box as text instead of reaching the output."""
    import ctypes

    libc = ctypes.CDLL(None)
    sys.stdout.flush()
    libc.fflush(None)
    saved = os.dup(1)
    with tempfile.TemporaryFile() as tmp:
        os.dup2(tmp.fileno(), 1)
        try:
            yield
        finally:
            sys.stdout.flush()
            libc.fflush(None)
            os.dup2(saved, 1)
            os.close(saved)
            tmp.seek(0)
            box.append(tmp.read().decode(errors="replace"))


@contextlib.contextmanager
def _held_to_plain(tag: str, kernels: tuple = ("gemm", "lu_block")):
    """Inside the block, the first call of each kernel in `kernels` at each
    distinct operand shape is held against its plain version on the same
    card tensors: the plain version runs just before the kernel, so an
    update in place is compared on its inputs. K1 (`hopper_kernels.gemm`)
    by relative Frobenius error (K1_TOL_F32 or K1_TOL_BF16), K2
    (`lu_block`) by equal pivots and alive rows in every slot and its output
    allclose K2_TOL, K3 (`btrsm_pair`, a solve round) by relative Frobenius
    error K3_TOL (its probe stats K3_STATS_TOL; a round with the fused
    probe is keyed apart, its dtype marked "probe", and an SPD round, back
    through L^T, marked "L^T"; a round whose rhs is
    not finite or all zero, an injected fault or a warm-up, is not
    compared); K4 (`batched_lu`) by equal pivots and its factors within
    K4_TOL max_abs (probe rows K4_WA_TOL), K5 (`batched_chol`) within
    K5_TOL (probe rows K5_WA_TOL). One line a kernel
    after the block; fails the phase on any disagreement, or if a kernel of
    `kernels` never ran. Yields the K3 records, {(T dtype, b shape): (x
    rel_fro, stats error, max_abs)}."""
    from conflux_tpu_torch.ops import hopper_kernels as hk

    gemm, lu_block, btrsm_pair = hk.gemm, hk.lu_block, hk.btrsm_pair
    batched_lu, batched_chol = hk.batched_lu, hk.batched_chol
    k1: dict = {}  # shape -> (rel_fro, tol, instance)
    k2: dict = {}  # shape -> (pivots and alive equal, max_abs, allclose)
    k3: dict = {}  # (T dtype, b shape) -> (rel_fro, stats error, max_abs)
    k45: dict = {}  # (name, dtype, shape) -> (agrees, max_abs)

    def held_factor(name, kernel, plain, tol, wa_tol):
        def held(A, w=None):
            got = kernel(A, w)
            key = (name, str(A.dtype).removeprefix("torch."), tuple(A.shape))
            if key not in k45 and bool(torch.isfinite(A).all()):
                want = plain(A, w)
                same = name != "batched_lu" or torch.equal(got[1], want[1])
                err = float((got[0] - want[0]).abs().max())
                wa_ok = got[-1] is None or rel_fro(got[-1], want[-1]) <= wa_tol
                k45[key] = (same and err <= tol[A.dtype] and wa_ok, err)
            return got
        return held

    def held_gemm(a, b, c=None, alpha=1.0, beta=1.0, out=None):
        key = (str(a.dtype).removeprefix("torch."), tuple(a.shape), tuple(b.shape))
        if key in k1:
            return gemm(a, b, c, alpha, beta, out=out)
        want = hk.gemm_plain(a, b, c, alpha, beta)
        got = gemm(a, b, c, alpha, beta, out=out)
        tol = K1_TOL_BF16 if a.dtype == torch.bfloat16 else K1_TOL_F32
        k1[key] = (rel_fro(got, want), tol, hk.gemm_instance(a, b, c, got))
        return got

    def held_lu_block(a, alive):
        got = lu_block(a, alive)
        if tuple(a.shape) not in k2:
            want = hk.lu_block_plain(a, alive)
            k2[tuple(a.shape)] = (torch.equal(got[2], want[2]) and torch.equal(got[1], want[1]),
                                  float((got[0] - want[0]).abs().max()),
                                  torch.allclose(got[0], want[0], rtol=K2_TOL, atol=K2_TOL))
        return got

    def held_btrsm_pair(T, Dl, Du, b, *, perm=None, trans_back=False, wA=None):
        got = btrsm_pair(T, Dl, Du, b, perm=perm, trans_back=trans_back, wA=wA)
        key = (str(T.dtype).removeprefix("torch.") + ("" if wA is None else " probe")
               + (" L^T" if trans_back else ""), tuple(b.shape))
        if key not in k3 and bool(torch.isfinite(b).all()) and bool(b.any()):
            want = hk.btrsm_pair_plain(T, Dl, Du, b, perm, trans_back, wA)
            x, xw = (got, want) if wA is None else (got[0], want[0])
            st = 0.0
            if wA is not None:
                st = max(float(((got[1] - want[1]).abs() / x.abs().sum(dim=(1, 2))).max()),
                         float(((got[2] - want[2]).abs()
                                / (wA * x[:, :, 0]).abs().sum(1)).max()))
            k3[key] = (rel_fro(x, xw), st, float((x - xw).abs().max()))
        return got

    hk.gemm, hk.lu_block, hk.btrsm_pair = held_gemm, held_lu_block, held_btrsm_pair
    hk.batched_lu = held_factor("batched_lu", batched_lu, hk.batched_lu_plain, K4_TOL,
                                K4_WA_TOL)
    hk.batched_chol = held_factor("batched_chol", batched_chol, hk.batched_chol_plain,
                                  {torch.float32: K5_TOL, torch.float64: K5_TOL}, K5_WA_TOL)
    try:
        yield k3
    finally:
        hk.gemm, hk.lu_block, hk.btrsm_pair = gemm, lu_block, btrsm_pair
        hk.batched_lu, hk.batched_chol = batched_lu, batched_chol
    ok = True
    for name, label in (("batched_lu", "K4"), ("batched_chol", "K5")):
        if name in kernels:
            recs = {k: v for k, v in k45.items() if k[0] == name}
            good = all(r[0] for r in recs.values())
            print(f"[{tag}] {label} on the path's own operands at {len(recs)} shapes "
                  f"({', '.join(f'{d} {sh}' for _n, d, sh in recs)}): pivots equal and within "
                  f"its bound {good}, worst max_abs "
                  f"{max((r[1] for r in recs.values()), default=float('nan')):.2e}", flush=True)
            ok = ok and good and len(recs) > 0
    if "gemm" in kernels:
        k1_ok = all(err <= tol for err, tol, _i in k1.values())
        print(f"[{tag}] K1 on the path's own operands at {len(k1)} shapes "
              f"({', '.join(f'{a}@{b} {d} {r[2]}' for (d, a, b), r in k1.items())}): worst "
              f"rel_fro {max((r[0] for r in k1.values()), default=float('nan')):.2e} against "
              f"the plain version (bounds {sorted({r[1] for r in k1.values()})}); all within "
              f"{k1_ok}", flush=True)
        ok = ok and k1_ok and len(k1) > 0
    if "lu_block" in kernels:
        k2_ok = all(same and close for same, _e, close in k2.values())
        print(f"[{tag}] K2 on the path's own operands at {len(k2)} shapes "
              f"({', '.join(map(str, k2))}): pivots and alive rows equal in every slot and "
              f"allclose {K2_TOL:g} {k2_ok}, worst max_abs "
              f"{max((r[1] for r in k2.values()), default=float('nan')):.2e}", flush=True)
        ok = ok and k2_ok and len(k2) > 0
    if "btrsm" in kernels:
        k3_ok = all(err <= K3_TOL and st <= K3_STATS_TOL for err, st, _m in k3.values())
        print(f"[{tag}] K3 rounds on the path's own operands at {len(k3)} shapes "
              f"({', '.join(f'{d} {s}' for d, s in k3)}): worst rel_fro "
              f"{max((r[0] for r in k3.values()), default=float('nan')):.2e} (bound "
              f"{K3_TOL:g}), probe stats {max((r[1] for r in k3.values()), default=0.0):.2e} "
              f"(bound {K3_STATS_TOL:g}); all within {k3_ok}", flush=True)
        ok = ok and k3_ok and len(k3) > 0
    check(ok, f"{tag}: a kernel disagrees with its plain version on the path, or never ran")


def phase_serve_f(k3: dict) -> dict:
    """(f) the HPL-MxP plan: a "kernel" LU plan at (32, 1024, 1024), f32,
    factor_dtype bfloat16, refine 2, v=256 (K2 panels and K1 updates on
    the bf16 factor, K3's bfloat16-T instance in every round)."""
    from conflux_tpu_torch import serve
    from conflux_tpu_torch.ops.hopper_kernels import (btrsm_pair, btrsm_pair_plain,
                                                      lu_block_launch_count)

    B, n, v, rounds = 32, 1024, 256, 16
    serve.clear_plans()
    plan = serve.FactorPlan.create((B, n, n), torch.float32, v=v,
                                   factor_dtype=torch.bfloat16, refine=2)
    check(plan.key.backend == "kernel" and plan.key.panel_algo == "kernel"
          and not plan._kernel_factor, f"(f) {plan.key}")
    A = _systems(B, n, 30)
    gen = torch.Generator(device="cuda").manual_seed(7)
    rhs = [torch.randn((B, n), generator=gen, device="cuda") for _ in range(rounds)]

    def drive():
        s = plan.factor(A)
        return s, [s.solve(b) for b in rhs]

    (s, xs), counts = _serve_counts(drive)
    # the code's own counts: K1 once per system and superstep with a
    # trailing block; K2 per 128-wide column block of each panel, as many
    # launches as its route takes for the 32 slots; K3 once per substitution
    # (the solve and each of its 2 sweeps)
    steps = n // v
    want = {"gemm": B * (steps - 1),
            "lu_block": sum((v // 128) * lu_block_launch_count(n - k * v, B, torch.device("cuda"))
                            for k in range(steps)),
            "btrsm": 3 * rounds}
    print(f"[serve f] plan {plan.key.shape} factor_dtype bfloat16 refine 2, v={v}: launches "
          f"{counts}, predicted {want}", flush=True)
    check(all(counts[k] == w for k, w in want.items()) and counts["batched_lu"] == 0,
          f"serving (f) launches {counts}, predicted {want}")
    check(counts["gemm_tma"] == counts["gemm"], f"serving (f) ran K1's SIMT instance: {counts}")
    # the factor itself, before any sweep could hide a fault in it
    LU, Dl, Du, perm = s.factors
    check(LU.dtype == torch.bfloat16, f"(f) factor dtype {LU.dtype}")
    fres = float(_lu_residuals(A, LU, perm).max())
    print(f"[serve f] factor residual max ||A[perm] - L U||_F / ||A||_F {fres:.3e} (bar "
          f"{BF16_FACTOR_BAR:g}, bf16 storage)", flush=True)
    check(fres <= BF16_FACTOR_BAR, f"serving (f) factor residual {fres:.3e}")
    # each K1 and K2 shape of the factor on the path's own operands
    with _held_to_plain("serve f"):
        plan.factor(A)
    worst = max(float((torch.einsum("bij,bj->bi", A, x) - b).abs().max())
                for x, b in zip(xs, rhs))
    print(f"[serve f] max |A x - b| after 2 sweeps {worst:.3e} (bar {SOLVE_TOL:g})", flush=True)
    check(worst < SOLVE_TOL, f"serving (f) max |A x - b| {worst:.3e}")
    fac_ms = time_ms(lambda: plan.factor(A), 3)
    solve_us = _rounds(s, rhs, False)
    print(f"[serve f] {fac_ms:.3f} ms per factor (CUDA events, 3 calls; {want['gemm']} K1 "
          f"launches, one per system and superstep); {solve_us:.1f} us per solve of 3 rounds "
          f"(host clock)", flush=True)
    # K3's bfloat16-T instance on the plan's own factors: against its plain
    # version, and bit for bit the float32 instance on the upcast factor
    b = rhs[0][:, :, None]
    wA = torch.randn((B, n), generator=gen, device="cuda")
    LUf = LU.float()
    x, xsum, wAx = btrsm_pair(LU, Dl, Du, b, perm=perm, wA=wA)
    ref = btrsm_pair(LUf, Dl, Du, b, perm=perm, wA=wA)
    want_x = btrsm_pair_plain(LU, Dl, Du, b, perm)
    torch.cuda.synchronize()
    err = rel_fro(x, want_x)
    same = all(torch.equal(g, r) for g, r in zip((x, xsum, wAx), ref))
    ev, ms = _both_ms(lambda: btrsm_pair(LU, Dl, Du, b, perm=perm))
    ev32, ms32 = _both_ms(lambda: btrsm_pair(LUf, Dl, Du, b, perm=perm))
    cast = time_ms(lambda: LU.float(), 20)
    print(f"[serve f] K3 bfloat16-T round at ({B}, {n}, {n}) k=1: rel_fro {err:.2e} against the "
          f"plain version (bound {K3_TOL:g}); bitwise the float32 instance on the upcast factor "
          f"{same}; a call (device): bf16-T {ev * 1e3:.1f} ({ms * 1e3:.1f}) us, f32-T "
          f"{ev32 * 1e3:.1f} ({ms32 * 1e3:.1f}) us; the per-round cast it saves "
          f"{cast * 1e3:.1f} us", flush=True)
    check(err <= K3_TOL and same, "K3 bfloat16-T instance")
    k3["max_abs_err"] = max(k3["max_abs_err"], float((x - want_x).abs().max()))
    del s, xs, LU, Dl, Du, LUf
    torch.cuda.empty_cache()
    return counts


def _rel64(x: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative Frobenius error in float64 (`rel_fro` rounds to float32)."""
    x, ref = x.double(), ref.double()
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def phase_solvers() -> None:
    """(s) the solver API at N=4096 in float64 (library route) and float32
    (kernel route), against torch.linalg; FGMRES at the JAX test's setup."""
    import numpy as np

    from conflux_tpu_torch import solvers
    from conflux_tpu_torch.lu.single import lu_factor_blocked
    from conflux_tpu_torch.validation import make_test_matrix, residual_bound

    gen = torch.Generator(device="cuda").manual_seed(8)
    for dtype, tol, route in ((torch.float64, 1e-10, _library_route),
                              (torch.float32, 1e-4, contextlib.nullcontext)):
        name = str(dtype).removeprefix("torch.")
        with route():
            Ap = _systems(1, 4093, 40, dtype)[0]
            bp = torch.randn(4093, generator=gen, device="cuda", dtype=dtype)
            x = solvers.solve(Ap, bp)
            xr = torch.linalg.solve(Ap, bp)
            e_solve = _rel64(x, xr)
            A = _systems(1, 4096, 41, dtype)[0]
            held = _held_to_plain(f"solvers {name}") if route is contextlib.nullcontext \
                else contextlib.nullcontext()
            with held:
                LU, perm = lu_factor_blocked(A, 256)
            fres = float(_lu_residuals(A[None], LU[None], perm[None])[0])
            check(fres <= residual_bound(4096, dtype), f"solvers {name} factor residual {fres:.3e}")
            sign, logabs = solvers.slogdet_from_lu(LU, perm)
            s_ref, l_ref = torch.linalg.slogdet(A)
            e_det = abs(logabs - float(l_ref)) / abs(float(l_ref))
            e_inv = _rel64(solvers.inv_from_lu(LU, perm), torch.linalg.inv(A))
            est = solvers.cond_estimate_1(A, LU, perm)
            exact = float(torch.linalg.cond(A.double(), 1))
        print(f"[solvers] {name} N=4096: factor residual {fres:.2e}; solve (N=4093, padded) "
              f"rel {e_solve:.2e} against "
              f"torch.linalg.solve; slogdet sign {sign:g} (torch {float(s_ref):g}), log|det| rel "
              f"{e_det:.2e}; inv_from_lu rel {e_inv:.2e}; cond_estimate_1 {est:.4g}, "
              f"torch.linalg.cond(A, 1) {exact:.4g}", flush=True)
        check(e_solve <= tol and sign == float(s_ref) and e_det <= tol and e_inv <= tol
              and exact / 3 <= est <= 3 * exact, f"solvers {name}")
        del A, LU, Ap
    # FGMRES with bf16 factors as the preconditioner (tests/test_solve.py's
    # setup: make_test_matrix(512) f32, cond ~1.4e3, v=64)
    n = 512
    A = torch.from_numpy(make_test_matrix(n, n, dtype=np.float32)).cuda()
    b_r = torch.ones(n, dtype=torch.float64, device="cuda")
    with _library_route():
        LU, perm = lu_factor_blocked(A.bfloat16(), 64)
    x = solvers.lu_solve(LU, perm, b_r.float()).double()
    for _ in range(6):
        r = solvers._residual_strips(A, x, b_r, torch.float64)
        x = x + solvers.lu_solve(LU, perm, r.float()).double()
    r = solvers._residual_strips(A, x, b_r, torch.float64)
    classic = float(torch.linalg.norm(r) / torch.linalg.norm(b_r))
    Ad = A.double()
    xg, info = solvers.fgmres(lambda v: Ad @ v, lambda rr: solvers.lu_solve(LU, perm, rr.float()),
                              b_r, tol=1e-6, restart=16, max_restarts=8, rdtype=torch.float64)
    print(f"[solvers] FGMRES on bf16 factors (N={n}, v=64): residual {info['residual']:.2e} "
          f"after {info['restarts']} cycles (bar 1e-6); 6 classic sweeps {classic:.2e} (stays "
          "above 1e-4)", flush=True)
    check(info["residual"] <= 1e-6 and classic > 1e-4, "FGMRES against classic refinement")
    torch.cuda.empty_cache()


def _drift(lead: tuple, n: int, k: int, gen) -> tuple:
    """A rank-k drift (U, V), entries standard normal / sqrt(n) (the JAX
    update tests' scale), made on the card."""
    return tuple(torch.randn(lead + (n, k), generator=gen, device="cuda") / math.sqrt(n)
                 for _ in range(2))


def _drifted_resid(A, U, V, x, b) -> float:
    """max |(A + U V^T) x - b| in float64, the drifted system's residual."""
    A1 = A.double() + U.double() @ V.double().mT
    return float((A1 @ x.double()[..., None] - b.double()[..., None]).abs().max())


def _backward_error(A, x, b) -> float:
    """Normwise backward error ||A x - b|| / (||A|| ||x|| + ||b||) per
    system in float64, the worst: the accuracy a backward-stable solve owes
    a near-singular system."""
    A, x, b = A.double(), x.double()[..., None], b.double()[..., None]
    r = torch.linalg.norm((A @ x - b).flatten(-2), dim=-1)
    den = (torch.linalg.matrix_norm(A, ord=2) * torch.linalg.norm(x.flatten(-2), dim=-1)
           + torch.linalg.norm(b.flatten(-2), dim=-1))
    return float((r / den).max())


def _near_singular_drift(A: torch.Tensor) -> tuple:
    """U = [e0, e1], V = [-(1 - 1e-7) A^T e0, 0] per system: the
    capacitance is diag(1e-7, 1) up to rounding (cond ~1e7, past the drift
    policy's 1e6) and the drifted matrix's row 0 is rounding-sized."""
    n = A.shape[-1]
    U = torch.zeros(A.shape[:-2] + (n, 2), device=A.device)
    U[..., 0, 0] = U[..., 1, 1] = 1.0
    V = torch.zeros_like(U)
    V[..., :, 0] = -(1 - 1e-7) * A[..., 0, :]
    return U, V


def phase_woodbury() -> dict:
    """(21) Woodbury serving at bench_refresh.py's shapes, float32: B=1
    (a (1024, 1024) plan, v=256), B=32 (256, 256) v=128, and serving (b)'s
    N=1024 as a (32, 1024, 1024) v=256 plan; 8 rounds of
    update(U, V, replace=True), solve and solve_checked at k=16. Then on
    the (1024, 1024) plan an accumulating drift past max_rank (K3 at k=16,
    32, 64 and 128, then one refactor), a near-singular drift (the cond
    trigger), refactor() and refine_checked."""
    from conflux_tpu_torch import resilience, serve

    rounds, k = 8, 16
    gen = torch.Generator(device="cuda").manual_seed(21)
    total: dict = {}

    def add(counts):
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val

    for name, B, n, v in (("B=1 N=1024", None, 1024, 256), ("B=32 N=256", 32, 256, 128),
                          ("B=32 N=1024", 32, 1024, 256)):
        lead = () if B is None else (B,)
        serve.clear_plans()
        plan = serve.FactorPlan.create(lead + (n, n), torch.float32, v=v)
        A = _systems(B or 1, n, 210 + n + (B or 1))
        A = A[0] if B is None else A
        drifts = [_drift(lead, n, k, gen) for _ in range(rounds)]
        rhs = [torch.randn(lead + (n,), generator=gen, device="cuda") for _ in range(rounds)]

        def drive():
            s = plan.factor(A)
            out = []
            for (U, V), b in zip(drifts, rhs):
                s.update(U, V, replace=True)
                out.append((s.solve(b), s.solve_checked(b)))
            return s, out

        with _held_to_plain(f"woodbury {name}", ("btrsm",)):
            (s, out), counts = _serve_counts(drive)
        add(counts)
        # the code's counts: K4 once (the factor), K3 once per capacitance,
        # per Woodbury solve and per checked solve (no sweeps)
        want = {"batched_lu": 1, "btrsm": 3 * rounds, "gemm": 0, "lu_block": 0}
        print(f"[woodbury] {name} plan {plan.key.shape} v={v} k={k}: launches {counts}, "
              f"predicted {want}; trace counts {plan.trace_counts}", flush=True)
        check(all(counts[c] == w for c, w in want.items()),
              f"woodbury {name} launches {counts}, predicted {want}")
        worst = max(_drifted_resid(A, U, V, x, b)
                    for (U, V), b, (x, _c) in zip(drifts, rhs, out))
        verdicts = torch.stack([c[1] for _x, c in out])
        same = all(torch.equal(x, c[0]) for x, c in out)
        print(f"[woodbury] {name}: max |(A + U V^T) x - b| {worst:.3e} (bar {SOLVE_TOL:g}); "
              f"checked verdicts finite min {float(verdicts[:, 0].min()):g}, residual max "
              f"{float(verdicts[:, 1].max()):.3e}; checked answers equal the plain ones {same}; "
              f"capacitance cond1 {s.last_cond:.3e}", flush=True)
        check(worst < SOLVE_TOL and same, f"woodbury {name} answers")
        check(bool((verdicts[:, 0] == 1.0).all()) and float(verdicts[:, 1].max()) < SOLVE_TOL,
              f"woodbury {name} checked verdicts")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for U, V in drifts:
            s.update(U, V, replace=True)
        torch.cuda.synchronize()
        upd_us = (time.perf_counter() - t0) / rounds * 1e6
        wood_us, wood_checked_us = _rounds(s, rhs, False), _rounds(s, rhs, True)
        s0 = plan.factor(A)
        plain_us, plain_checked_us = _rounds(s0, rhs, False), _rounds(s0, rhs, True)
        print(f"[woodbury] {name}: {upd_us:.1f} us per update (its cond read syncs), "
              f"{wood_us:.1f} us per Woodbury round, {wood_checked_us:.1f} us per checked "
              f"round; the undrifted session {plain_us:.1f} / {plain_checked_us:.1f} us (host "
              f"clock, {rounds} rounds)", flush=True)
        del s, s0, out
    # the (1024, 1024) plan: accumulate 9 drifts of rank 16 (capacitances at
    # kb 16, 32, 64, 64, 128, 128, 128, 128; the 9th passes max_rank 128 and
    # refactors), a solve, refactor() and refine_checked
    n = 1024
    serve.clear_plans()
    plan = serve.FactorPlan.create((n, n), torch.float32, v=256)
    A = _systems(1, n, 220)[0]
    drifts = [_drift((), n, k, gen) for _ in range(9)]
    b = torch.randn((n,), generator=gen, device="cuda")

    def accumulate():
        s = plan.factor(A)
        ranks = []
        for U, V in drifts:
            s.update(U, V)
            ranks.append(s.update_rank)
        x = s.solve(b)
        s.refactor()
        x2, verdict = s.refine_checked(b, s.solve(b))
        return s, ranks, x, x2, verdict

    with _held_to_plain("woodbury accumulate", ("btrsm",)) as k3:
        (s, ranks, x, x2, verdict), counts = _serve_counts(accumulate)
    add(counts)
    want = {"batched_lu": 3, "btrsm": 8 + 1 + 2}
    Uall = torch.cat([U for U, _V in drifts], -1)
    Vall = torch.cat([V for _U, V in drifts], -1)
    worst = max(_drifted_resid(A, Uall, Vall, y, b) for y in (x, x2))
    widths = sorted({key[1][-1] for key in k3})
    print(f"[woodbury] accumulate 9 x rank {k} at N={n}: ranks {ranks}, refactors "
          f"{s.refactors}; launches {counts}, predicted {want}; K3 held at k {widths}; max "
          f"|(A + sum U V^T) x - b| {worst:.3e} after the refactor, the refactor() and "
          f"refine_checked (verdict {verdict.tolist()})", flush=True)
    check(ranks == [16, 32, 48, 64, 80, 96, 112, 128, 0] and s.refactors == 2
          and s.factorizations == 3, f"woodbury accumulate: ranks {ranks}, {s.refactors}")
    check(all(counts[c] == w for c, w in want.items()) and 128 in widths,
          f"woodbury accumulate launches {counts}, predicted {want}, widths {widths}")
    check(worst < SOLVE_TOL and float(verdict[0]) == 1.0 and float(verdict[1]) < SOLVE_TOL,
          "woodbury accumulate answers")
    _k3_wide_times(plan, A, gen)
    U2, V2 = _near_singular_drift(A)
    before = resilience.health_stats()["cond_refactors"]

    def near_singular():
        s3 = plan.factor(A)
        s3.update(U2, V2)
        return s3, s3.solve(b)

    (s3, x3), counts = _serve_counts(near_singular)
    add(counts)
    want = {"batched_lu": 2, "btrsm": 2}
    berr = _backward_error(s3._A0, x3, b)
    print(f"[woodbury] near-singular drift: cond1 {s3.last_cond:.3e} (limit 1e6), refactors "
          f"{s3.refactors}, cond_refactors +"
          f"{resilience.health_stats()['cond_refactors'] - before}; launches {counts}, "
          f"predicted {want}; backward error of the refactored solve {berr:.2e} (bar 1e-5)",
          flush=True)
    check(s3.last_cond > 1e6 and s3.refactors == 1 and s3.update_rank == 0
          and resilience.health_stats()["cond_refactors"] == before + 1,
          "woodbury near-singular drift did not refactor on the cond trigger")
    check(all(counts[c] == w for c, w in want.items()) and berr < 1e-5,
          f"woodbury near-singular: launches {counts}, backward error {berr:.2e}")
    del s, s3
    torch.cuda.empty_cache()
    return total


def _k3_wide_times(plan, A, gen) -> None:
    """K3's capacitance round on a (1024, 1024) plan's factors at k=16 and
    k=128 (the max_rank bucket), a call's CUDA events and its device time
    in a CUDA graph, beside its plain version, `torch.linalg.lu_solve` and
    the round's bound."""
    from conflux_tpu_torch.ops.hopper_kernels import btrsm_pair, btrsm_pair_plain

    LU, Dl, Du, perm = plan._factor_once(A)
    T, Dl, Du, perm = LU[None], Dl[None], Du[None], perm[None]
    pivots = _lapack_pivots(perm)
    for k in (16, 128):
        U = torch.randn((1, A.shape[-1], k), generator=gen, device="cuda")
        ev, ms = _both_ms(lambda: btrsm_pair(T, Dl, Du, U, perm=perm))
        plain = time_ms(lambda: btrsm_pair_plain(T, Dl, Du, U, perm), 5)
        lib, lib_g = _both_ms(lambda: torch.linalg.lu_solve(T, pivots, U))
        r = _btrsm_bound(1, A.shape[-1], k, Dl.shape[1], Dl.shape[-1], 4)
        print(f"[woodbury] K3 round at (1, {A.shape[-1]}, {A.shape[-1]}) k={k}, a call "
              f"(device): kernel {ev * 1e3:.1f} ({ms * 1e3:.1f}) us, plain {plain * 1e3:.1f} us, "
              f"torch.linalg.lu_solve {lib * 1e3:.1f} ({lib_g * 1e3:.1f}) us, bound "
              f"{2 * r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})", flush=True)


def _ill_conditioned(B: int, n: int, cond: float = 1e6) -> torch.Tensor:
    """tests/test_precision.py's `_ill_conditioned` recipe at (B, n, n) on
    the card: Q diag(logspace(0, -log10(cond), n)) Q^T, Q of a normal
    matrix's QR in float64."""
    g = torch.Generator(device="cuda").manual_seed(22)
    Q = torch.linalg.qr(torch.randn((B, n, n), generator=g, device="cuda",
                                    dtype=torch.float64))[0]
    sv = torch.logspace(0, -math.log10(cond), n, dtype=torch.float64, device="cuda")
    return ((Q * sv) @ Q.mT).float()


def _rel_resid(A, x, b) -> float:
    """max over systems of ||A x - b|| / ||b||, in float64."""
    r = A.double() @ x.double()[..., None] - b.double()[..., None]
    return float((torch.linalg.norm(r.flatten(-2), dim=-1)
                  / torch.linalg.norm(b.double().flatten(-1), dim=-1)).max())


def phase_ladder() -> dict:
    """(22) The precision ladder on a (32, 1024, 1024) kernel-route float32
    LU plan, v=256, refine 1: the bf16_ir session (K2, K1, then K3's
    bfloat16-T instance), solves at bf16_ir, f32 (bit for bit the native
    session) and f64 (the library route, K3's float64-T instance), and
    'auto' with `resilience.escalate_precision` on cond-1e6 systems."""
    from conflux_tpu_torch import resilience, serve
    from conflux_tpu_torch.ops.hopper_kernels import lu_block_launch_count

    B, n, v = 32, 1024, 256
    serve.clear_plans()
    plan = serve.FactorPlan.create((B, n, n), torch.float32, v=v, refine=1)
    A = _systems(B, n, 50)
    gen = torch.Generator(device="cuda").manual_seed(23)
    b = torch.randn((B, n), generator=gen, device="cuda")
    total: dict = {}

    def counted(tag, fn, want):
        out, counts = _serve_counts(fn)
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val
        print(f"[ladder] {tag}: launches {counts}, predicted {want}", flush=True)
        check(all(counts[c] == w for c, w in want.items()), f"ladder {tag}: {counts}")
        return out

    native = counted("native factor", lambda: plan.factor(A),
                     {"batched_lu": 1, "gemm": 0, "lu_block": 0, "btrsm": 0})
    steps = n // v
    k2 = sum((v // 128) * lu_block_launch_count(n - j * v, B, torch.device("cuda"))
             for j in range(steps))
    with _held_to_plain("ladder bf16_ir factor"):
        tiered = counted("factor(precision='bf16_ir')",
                         lambda: plan.factor(A, precision="bf16_ir"),
                         {"batched_lu": 0, "gemm": B * (steps - 1), "lu_block": k2,
                          "btrsm": 0})
    ratio = tiered.nbytes / native.nbytes
    print(f"[ladder] bf16_ir session {tiered.nbytes} bytes, native {native.nbytes}: ratio "
          f"{ratio:.3f} (bar 0.85); factor dtype {tiered.factors[0].dtype}", flush=True)
    check(ratio < 0.85 and tiered.served_tier == "bf16_ir"
          and tiered.factors[0].dtype == torch.bfloat16, "ladder bf16_ir session")
    with _held_to_plain("ladder solves", ("btrsm",)) as k3:
        xb = counted("bf16_ir solve (1 sweep)", lambda: tiered.solve(b),
                     {"btrsm": 2, "gemm": 0, "lu_block": 0})
        x32 = counted("solve(precision='f32') on the native session (its tier factor: K4)",
                      lambda: native.solve(b, precision="f32"),
                      {"batched_lu": 1, "btrsm": 2, "gemm": 0, "lu_block": 0})
        x64 = counted("solve(precision='f64') (library factor, K3 float64-T)",
                      lambda: native.solve(b, precision="f64"),
                      {"batched_lu": 0, "gemm": 0, "lu_block": 0, "btrsm": 2})
    dtypes = sorted({d for d, _s in k3})
    xnat = native.solve(b)
    bitwise = torch.equal(x32, xnat) and all(
        torch.equal(f, g) for f, g in zip(native._tier_factors["f32"], native.factors))
    res = {t: _rel_resid(A, x, b) for t, x in (("bf16_ir", xb), ("f32", x32), ("f64", x64))}
    print(f"[ladder] ||A x - b|| / ||b||: bf16_ir {res['bf16_ir']:.2e} (bar 1e-2), f32 "
          f"{res['f32']:.2e}, f64 {res['f64']:.2e} (bar 1e-5); the f32 tier bit for bit the "
          f"native session (factors and answer) {bitwise}; K3 instances held {dtypes}; f64 "
          f"tier Dinv {native._tier_factors['f64'][1].dtype}", flush=True)
    check(res["bf16_ir"] < 1e-2 and res["f32"] < 1e-5 and res["f64"] < 1e-5 and bitwise,
          "ladder tier answers")
    check(dtypes == ["bfloat16", "float32", "float64"]
          and native._tier_factors["f64"][1].dtype == torch.float64, f"ladder K3 {dtypes}")
    nat_ms = time_ms(lambda: plan.factor(A), 3)
    bf_ms = time_ms(lambda: plan.factor(A, precision="bf16_ir"), 3)
    f64_ms = time_ms(lambda: plan._tier_factor_once("f64", A), 2)
    us = {t: _rounds_at(s_, b, p) for t, s_, p in (("bf16_ir", tiered, None),
                                                   ("f32", native, "f32"),
                                                   ("f64", native, "f64"))}
    print(f"[ladder] factor ms (CUDA events): native (K4) {nat_ms:.3f}, bf16_ir (K2 + K1) "
          f"{bf_ms:.3f}, f64 tier (library route) {f64_ms:.3f}; us per solve of 2 rounds (host "
          f"clock): bf16_ir {us['bf16_ir']:.1f}, f32 {us['f32']:.1f}, f64 {us['f64']:.1f}",
          flush=True)
    del tiered
    # 'auto' on ill-conditioned systems: the bf16 rung fails its verdict,
    # the ladder climbs, and the rung sticks
    Abad = _ill_conditioned(B, n)
    pol = resilience.HealthPolicy()
    limit = pol.resolved_residual_limit("float32", n)

    def auto():
        sa = plan.factor(Abad, precision="auto")
        x, verdict = sa.solve_checked(b, precision="auto")
        ok, finite, r = resilience.evaluate(verdict, limit)
        out = resilience.escalate_precision(
            sa, b[..., None], "auto", pol, limit,
            evidence0={"rung": "bf16_ir", "finite": finite, "residual": r})
        return sa, ok, r, out

    # the auto session's bf16 factor (K1, K2), then the f32 rung's tier
    # factor (K4) on the climb
    sa, ok0, r0, out = counted("'auto' + escalate_precision (cond 1e6)", auto,
                               {"batched_lu": 1, "gemm": B * (steps - 1), "lu_block": k2})
    x2, v2 = sa.solve_checked(b, precision="auto")
    ok2, _f, r2 = resilience.evaluate(v2, limit)
    rout = _rel_resid(Abad, torch.from_numpy(out[..., 0]).cuda(), b)
    print(f"[ladder] auto on cond 1e6: bf16_ir verdict residual {r0:.3e} > limit {limit:.3e} "
          f"{not ok0}; climbed to rung {sa.auto_rung} ({serve.PRECISION_TIERS[sa.auto_rung]}), "
          f"{sa.precision_escalations} escalation(s); answer ||A x - b|| / ||b|| {rout:.2e} "
          f"(bar 1e-2); the next auto request healthy {ok2} (residual {r2:.3e})", flush=True)
    check(not ok0 and sa.auto_rung >= 1 and sa.precision_escalations >= 1 and rout < 1e-2
          and ok2, "ladder auto escalation")
    del native, sa
    torch.cuda.empty_cache()
    return total


def _rounds_at(s, b, precision) -> float:
    """Host microseconds per `s.solve(b, precision=...)` over 16 calls."""
    s.solve(b, precision=precision)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        s.solve(b, precision=precision)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 16 * 1e6


def _qr_flops(M: int, N: int) -> float:
    """LAPACK's count for a Householder QR of an (M, N) matrix, M >= N:
    2 M N^2 - 2 N^3 / 3 (the rate's numerator; the blocked and tree
    algorithms do more)."""
    return 2.0 * M * N * N - 2.0 * N ** 3 / 3


def phase_qr() -> dict:
    """(23) The QR miniapp's `main(argv)`: --full at N=32768 f32 -b 1024
    --validate, through `qr.distributed.qr_factor_distributed` on 1x1x1
    (its trailing update on K1: only K1 launches, in the count
    `gemm_launches` predicts for the warm-up and the timed run, the first
    call at each of the path's shapes held against the plain version, every
    launch the TMA instance), and tall mode at M=1048576, 256 columns,
    --algo tsqr and cholesky, each --validate, which launch no kernel (the
    JAX package runs no Pallas kernel there either). Returns the --full
    run's launches."""
    from conflux_tpu_torch.geometry import Grid3, LUGeometry
    from conflux_tpu_torch.qr.distributed import gemm_launches
    from conflux_tpu_torch.validation import residual_bound

    runs = (["--full", "-M", "32768", "--cols", "32768", "-b", "1024"],
            ["-M", "1048576", "--cols", "256", "--algo", "tsqr"],
            ["-M", "1048576", "--cols", "256", "--algo", "cholesky"])
    full_counts: dict = {}
    for argv in runs:
        if "--full" in argv:
            with _held_to_plain("qr 23", ("gemm",)):
                lines, counts = run_miniapp([*argv, "--validate", "-r", "1"], app="qr_miniapp",
                                            kernels=("gemm",))
            want = 2 * gemm_launches(LUGeometry.create(32768, 32768, 1024, Grid3(1, 1, 1)))
            others = {k: n for k, n in counts.items() if not k.startswith("gemm") and n}
            print(f"[qr]   --full K1 launches {counts['gemm']}, predicted {want} (warm-up + 1 "
                  f"timed factorization); other kernels {others or 'none'}", flush=True)
            check(counts["gemm"] == want and not others,
                  f"qr --full: launches {counts}, K1 predicted {want}")
            _only_tma(counts, "qr")
            full_counts = counts
        else:
            lines, counts = run_miniapp([*argv, "--validate", "-r", "1"], app="qr_miniapp",
                                        kernels=())
            check(all(c == 0 for c in counts.values()), f"qr {argv}: kernels launched {counts}")
        f = _field(lines, "_result_").split()[1].split(",")
        ms = float(f[8])
        M, N = int(argv[argv.index("-M") + 1]), int(argv[argv.index("--cols") + 1])
        res = _field(lines, "_residual_")
        orth = float(res.split("orth=")[1].split()[0])
        rec = float(res.split("reconstruction=")[1])
        bar = residual_bound(N, torch.float32)
        print(f"[qr] {f[0]} M={M} N={N}: {ms:.1f} ms = "
              f"{_qr_flops(M, N) / ms / 1e9:.1f} TFLOP/s at 2MN^2 - 2N^3/3 flops ({CARD}); "
              f"orth {orth:.3e}, reconstruction {rec:.3e} (bar {bar:.3e})", flush=True)
        if "--full" in argv:
            print(f"[qr]   --full on qr_factor_distributed: {ms:.1f} ms, beside the "
                  "11224.0 ms the route's earlier single-device stand-in "
                  "qr_factor_blocked(reproject=True) took (NVIDIA H100 80GB HBM3, 700.00 W)",
                  flush=True)
        check(orth <= bar and rec <= bar, f"qr {argv} residuals")
        torch.cuda.empty_cache()
    _qr_chunk_round()
    return full_counts


def _qr_chunk_round() -> None:
    """The tree's chunk round at the --full run's first panel, one batched
    `torch.linalg.qr(mode='r')` of (8, 4096, 1024) f32, timed (CUDA events,
    median of 3) on torch's default linear-algebra backend and on cuSOLVER,
    as PR 7 timed the library LU (torch sends a MAGMA request for QR to
    cuSOLVER)."""
    import statistics

    g = torch.Generator(device="cuda").manual_seed(24)
    P = torch.randn((8, 4096, 1024), generator=g, device="cuda")
    was = torch.backends.cuda.preferred_linalg_library()
    times = {}
    try:
        for lib in ("default", "cusolver"):
            torch.backends.cuda.preferred_linalg_library(lib)
            times[lib] = statistics.median(
                time_ms(lambda: torch.linalg.qr(P, mode="r"), 1) for _ in range(3))
    finally:
        torch.backends.cuda.preferred_linalg_library(was)
    print(f"[qr] chunk round torch.linalg.qr(mode='r') of (8, 4096, 1024) f32: "
          + ", ".join(f"{lib} {ms:.2f} ms" for lib, ms in times.items()), flush=True)


def phase_qr_lane() -> None:
    """(24) kind='qr' plans at (16384, 1024) float32 and float64: factor,
    the factor lane's checked program, 16 solve and 16 checked rounds, held
    to `torch.linalg.lstsq`; the verdict trips on a corrupted R; `lstsq` at
    (32768, 1024) float64 and float32 with bfloat16 factors and 2 sweeps.
    No kernel launches."""
    from conflux_tpu_torch import serve, solvers

    M, N, rounds = 16384, 1024, 16
    gen = torch.Generator(device="cuda").manual_seed(25)
    for dtype, bar in ((torch.float32, 1e-4), (torch.float64, 1e-9)):
        name = str(dtype).removeprefix("torch.")
        serve.clear_plans()
        plan = serve.FactorPlan.create((M, N), dtype, kind="qr")
        A = torch.randn((M, N), generator=gen, device="cuda", dtype=torch.float64).to(dtype)
        rhs = [torch.randn((M,), generator=gen, device="cuda", dtype=dtype)
               for _ in range(rounds)]

        def drive():
            s = plan.factor(A)
            _F, _p, verdict = plan._factor_health_fn(1)(A[None])
            return s, verdict, [s.solve(b) for b in rhs], [s.solve_checked(b) for b in rhs]

        (s, lane, xs, checked), counts = _serve_counts(drive)
        check(all(c == 0 for c in counts.values()), f"qr lane {name} launched {counts}")
        ref = torch.linalg.lstsq(A.double(), torch.stack(rhs, 1).double()).solution
        err = float((torch.stack(xs, 1).double() - ref).abs().max())
        verdicts = torch.stack([v for _x, v in checked])
        limit = 1e4 * torch.finfo(dtype).eps * math.sqrt(N)
        Q, R = s.factors
        R2 = R.clone()
        R2[:N // 2, N // 2:] = 0
        with s._lock:
            s._factors = (Q, R2)
        _x, bad = s.solve_checked(rhs[0])
        s.refactor()
        print(f"[qr lane] {name} plan {plan.key.shape}: launches {counts}; max |x - "
              f"torch.linalg.lstsq (float64)| {err:.2e} (bar {bar:g}); lane verdict "
              f"{lane[:, 0].tolist()}; checked verdicts finite min "
              f"{float(verdicts[:, 0].min()):g}, residual max {float(verdicts[:, 1].max()):.3e} "
              f"(limit {limit:.3e}); corrupted R verdict {bad.tolist()}", flush=True)
        check(err < bar, f"qr lane {name} answers")
        check(bool((verdicts[:, 0] == 1.0).all()) and float(verdicts[:, 1].max()) <= limit
              and float(lane[0, 0]) == 1.0 and float(lane[1, 0]) <= limit,
              f"qr lane {name} verdicts")
        check(float(bad[0]) == 1.0 and float(bad[1]) > limit,
              f"qr lane {name}: the corrupted R did not trip the verdict")
        fac_ms = time_ms(lambda: plan.factor(A), 3)
        lane_ms = time_ms(lambda: plan._factor_health_fn(1)(A[None]), 3)
        lib_ms = time_ms(lambda: torch.linalg.lstsq(A, rhs[0][:, None]), 3)
        print(f"[qr lane] {name}: {fac_ms:.3f} ms per factor, {lane_ms:.3f} ms per checked lane "
              f"factor, torch.linalg.lstsq {lib_ms:.3f} ms (CUDA events, 3 calls); "
              f"{_rounds(s, rhs, False):.1f} us per solve round, {_rounds(s, rhs, True):.1f} us "
              f"per checked round (host clock)", flush=True)
        del s, xs, checked
    M = 32768
    A = torch.randn((M, N), generator=gen, device="cuda", dtype=torch.float64)
    b = torch.randn((M,), generator=gen, device="cuda", dtype=torch.float64)
    (x,), counts = _serve_counts(lambda: (solvers.lstsq(A, b),))
    ref = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
    err64 = float((x - ref).abs().max())
    ms64 = time_ms(lambda: solvers.lstsq(A, b), 3)
    lib64 = time_ms(lambda: torch.linalg.lstsq(A, b[:, None]), 3)
    A32 = A.float()
    x_true = torch.randn((N,), generator=gen, device="cuda")
    b32 = A32 @ x_true
    errs = {}
    for sweeps in (0, 2):
        xr = solvers.lstsq(A32, b32, factor_dtype=torch.bfloat16, refine=sweeps)
        errs[sweeps] = float(torch.linalg.norm(xr - x_true) / torch.linalg.norm(x_true))
    ms32 = time_ms(lambda: solvers.lstsq(A32, b32, factor_dtype=torch.bfloat16, refine=2), 3)
    print(f"[lstsq] float64 ({M}, {N}): max |x - torch.linalg.lstsq| {err64:.2e} (bar 1e-9), "
          f"{ms64:.3f} ms, torch.linalg.lstsq {lib64:.3f} ms; float32 with bfloat16 factors: "
          f"relative error {errs[0]:.2e} without sweeps (above 1e-4), {errs[2]:.2e} after 2 "
          f"(bar 1e-5), {ms32:.3f} ms; launches {counts}", flush=True)
    check(err64 < 1e-9 and errs[0] > 1e-4 and errs[2] < 1e-5, "lstsq answers")
    check(all(c == 0 for c in counts.values()), f"lstsq launched {counts}")
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# 25-27: the serving engine (`engine.ServeEngine`) on the card
# --------------------------------------------------------------------------- #

ENGINE_WIDTHS = (1, 1, 2, 4)   # bench_engine.py's request-width profile
GANG_WIDTHS = (1, 1, 1, 2)     # bench_engine.py --gang's profile


def _engine_trace(sessions, R: int, widths, seed: int) -> list:
    """(session, host rhs) pairs: request i goes to session i mod len, at
    width widths[i mod len(widths)] (width 1 as a vector)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(R):
        s = sessions[i % len(sessions)]
        w = widths[i % len(widths)]
        lead = (s.plan.B, s.plan.N) if s.plan.batched else (s.plan.N,)
        out.append((s, rng.standard_normal(lead if w == 1 else lead + (w,))
                    .astype(np.float32)))
    return out


def _direct(trace) -> list:
    """Each request's direct `session.solve` answer, on the host."""
    return [s.solve(torch.from_numpy(b).cuda()).cpu().numpy() for s, b in trace]


def _engine_leg(eng, trace, timeout: float = 600.0):
    """Submit the whole trace, wait for every answer; (answers, seconds)."""
    t0 = time.perf_counter()
    futs = [eng.submit(s, b) for s, b in trace]
    xs = [f.result(timeout) for f in futs]
    return xs, time.perf_counter() - t0


def _sequential_leg(trace) -> float:
    """The same trace without the engine: one `session.solve` per request,
    its answer copied to the host; seconds."""
    t0 = time.perf_counter()
    for s, b in trace:
        s.solve(torch.from_numpy(b).cuda()).cpu()
    return time.perf_counter() - t0


def _max_resid(trace, xs) -> float:
    """max |A x - b| over the trace, on the card in float32."""
    worst = 0.0
    for (s, b), x in zip(trace, xs):
        A = s._A0
        bx = torch.from_numpy(b).cuda()
        xx = torch.from_numpy(x).cuda()
        if bx.dim() == A.dim() - 1:
            bx, xx = bx[..., None], xx[..., None]
        worst = max(worst, float((A @ xx - bx).abs().max()))
    return worst


def _median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2]


def _programs(*plans) -> int:
    """Serve programs the plans have made (`FactorPlan.trace_counts`)."""
    return sum(sum(p.trace_counts.values()) for p in plans)


def phase_engine_solve() -> dict:
    """(25) The engine's solve lane at bench_engine.py's shape: two
    sessions of a (32, 256, 256) f32 LU plan and one of a (256, 256) plan,
    v=128, 128 requests of widths 1,1,2,4, max_coalesce_width 32,
    max_batch_delay 2 ms, after prewarm of widths 1..32. Every answer
    bitwise the direct solve, max |A x - b| < SOLVE_TOL, no build after
    prewarm (no kernel build, no program made), K3 once per batch and the
    first K3 round at each (T dtype, b shape) the engine gives it held
    against its plain version (12 requests go alone first, so each
    session's widths 1, 2 and 4 reach K3 uncoalesced); timed on a second
    engine; then a guarded engine in which a request
    poisoned after admission fails alone, its probe rounds held the same
    way."""
    from conflux_tpu_torch import profiler, serve
    from conflux_tpu_torch.engine import ServeEngine
    from conflux_tpu_torch.ops import hopper_kernels
    from conflux_tpu_torch.resilience import (FaultPlan, FaultSpec, HealthPolicy,
                                              RhsNonFinite)

    B, n, R = 32, 256, 128
    serve.clear_plans()
    bplan = serve.FactorPlan.create((B, n, n), torch.float32, v=128)
    splan = serve.FactorPlan.create((n, n), torch.float32, v=128)
    sessions = [bplan.factor(_systems(B, n, 250)), bplan.factor(_systems(B, n, 251)),
                splan.factor(_systems(1, n, 252)[0])]
    trace = _engine_trace(sessions, R, ENGINE_WIDTHS, 25)
    direct = _direct(trace)
    with ServeEngine(max_batch_delay=0.002, max_coalesce_width=32) as eng:
        for s in sessions:
            eng.prewarm(s, widths=(1, 2, 4, 8, 16, 32))
        builds0, made0 = profiler.compile_count(), _programs(bplan, splan)
        torch.cuda.synchronize()
        hopper_kernels.reset_launches()
        with _held_to_plain("engine 25", ("btrsm",)):
            # one at a time first: each session's narrow widths (1, 2, 4)
            # reach K3 alone, then the trace coalesces
            solo = [eng.submit(s, b).result(600) for s, b in trace[:12]]
            xs, _s = _engine_leg(eng, trace)
            torch.cuda.synchronize()
        counts = dict(hopper_kernels.LAUNCHES)
        st = eng.stats()
        builds = profiler.compile_count() - builds0
        made = _programs(bplan, splan) - made0
        bitwise = sum(int(x.shape == d.shape and bool((x == d).all()))
                      for x, d in zip(xs, direct))
        solo_ok = all(x.shape == d.shape and bool((x == d).all())
                      for x, d in zip(solo, direct))
        worst = _max_resid(trace, xs)
        print(f"[engine 25] 12 requests alone, then {R}: {st['batches']} batches (coalesced mean "
              f"{st['coalesced_mean']:.2f}), launches {counts}; bitwise the direct solve "
              f"{bitwise}/{R}; max |A x - b| {worst:.3e} (bar {SOLVE_TOL:g}); after "
              f"prewarm {builds} kernel builds, {made} programs made", flush=True)
        check(bitwise == R and solo_ok,
              f"engine answers bitwise the direct solve: {bitwise}/{R}, alone {solo_ok}")
        check(worst < SOLVE_TOL, f"engine max |A x - b| {worst:.3e}")
        check(builds == 0 and made == 0,
              f"{builds} kernel builds, {made} programs made after prewarm")
        check(counts["btrsm"] == st["batches"] and counts["batched_lu"] == 0,
              f"K3 launches {counts['btrsm']} != batches {st['batches']}: {counts}")
    # timed on an engine of its own: the held leg above waits for the card
    with ServeEngine(max_batch_delay=0.002, max_coalesce_width=32) as eng:
        for s in sessions:
            eng.prewarm(s, widths=(1, 2, 4, 8, 16, 32))
        eng_s = [_engine_leg(eng, trace)[1] for _ in range(5)]
        seq_s = [_sequential_leg(trace) for _ in range(5)]
        torch.cuda.synchronize()
        st = eng.stats()
    print(f"[engine 25] {R / _median(eng_s):.1f} solves/s through the engine vs "
          f"{R / _median(seq_s):.1f} sequential session.solve (+ copy to the host), "
          f"median of 5 legs each; coalesced mean {st['coalesced_mean']:.2f}; latency "
          f"p50 {st['latency_p50_ms']:.3f} ms, p95 {st['latency_p95_ms']:.3f} ms, p99 "
          f"{st['latency_p99_ms']:.3f} ms (host clock, {st['completed']} requests)",
          flush=True)
    # the guarded engine: a NaN rhs is refused at submit; a request poisoned
    # after admission (the 'staging' fault site) fails alone
    faults = FaultPlan([FaultSpec("staging", "nan", count=1)])
    with _held_to_plain("engine 25 guarded", ("btrsm",)), \
            ServeEngine(max_batch_delay=0.002, health=HealthPolicy(),
                        fault_plan=faults) as eng:
        for s in sessions:
            eng.prewarm(s, widths=(1, 2, 4, 8, 16, 32))
        bad = trace[2][1].copy()
        bad[7] = float("nan")
        try:
            eng.submit(sessions[2], bad)
            refused = False
        except RhsNonFinite:
            refused = True
        gtrace = trace[:32]
        futs = [eng.submit(s, b) for s, b in gtrace]
        failed, good = [], 0
        for i, f in enumerate(futs):
            try:
                x = f.result(600)
            except RhsNonFinite:
                failed.append(i)
                continue
            good += int(bool((x == direct[i]).all()))
    print(f"[engine 25] guarded: NaN rhs refused at submit {refused}; after-admission "
          f"poison failed alone {failed} (injected {dict(faults.injected)}), the other "
          f"{good}/{len(gtrace) - len(failed)} bitwise the direct solve", flush=True)
    check(refused, "a NaN rhs was admitted by the guarded engine")
    check(len(failed) == 1 and good == len(gtrace) - 1,
          f"guarded engine: failed {failed}, {good} good")
    del sessions
    torch.cuda.empty_cache()
    return counts


def phase_engine_factor() -> dict:
    """(26) The factor lane at bench_engine.py --factor's scale: 32 cold
    starts of a (256, 256) f32 LU plan through `submit_factor` after
    prewarm of factor batches 1..32, then the same for an SPD plan; one K4
    (K5) launch per coalesced batch, every session bitwise `plan.factor`'s,
    no kernel build and no program made after prewarm, sessions/s beside
    the sequential `plan.factor` loop. K4 and K5 are held against their
    plain versions at the lane's full bucket, (32, 256, 256), in phases 8
    and 13; a slot's factors do not depend on the bucket (so every
    session here is bitwise its `plan.factor` twin, a bucket-1 launch)."""
    from conflux_tpu_torch import profiler, serve
    from conflux_tpu_torch.engine import ServeEngine
    from conflux_tpu_torch.ops import hopper_kernels

    n, F = 256, 32
    total: dict = {}
    for kind, gen, kernel in (("lu", _systems, "batched_lu"),
                              ("chol", _spd_systems, "batched_chol")):
        serve.clear_plans()
        plan = serve.FactorPlan.create((n, n), torch.float32, v=128, kind=kind)
        Ah = gen(F, n, 26).cpu().numpy()
        with ServeEngine(max_batch_delay=0.002, max_factor_batch=32) as eng:
            eng.prewarm(plan, factor_batches=(1, 2, 4, 8, 16, 32))
            builds0, made0 = profiler.compile_count(), _programs(plan)
            torch.cuda.synchronize()
            hopper_kernels.reset_launches()
            t0 = time.perf_counter()
            futs = [eng.submit_factor(plan, Ah[i]) for i in range(F)]
            sessions = [f.result(600) for f in futs]
            first_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = dict(hopper_kernels.LAUNCHES)
            st = eng.stats()
            builds = profiler.compile_count() - builds0
            made = _programs(plan) - made0
            refs = [plan.factor(Ah[i]) for i in range(F)]
            bitwise = sum(int(all(torch.equal(a, b) for a, b in zip(s.factors, r.factors)))
                          for s, r in zip(sessions, refs))
            print(f"[engine 26] {kind}: {F} cold starts in {st['factor_batches']} batches "
                  f"(coalesced mean {st['factor_coalesced_mean']:.1f}), launches {counts}; "
                  f"sessions bitwise plan.factor's {bitwise}/{F}; after prewarm {builds} "
                  f"kernel builds, {made} programs made", flush=True)
            check(counts[kernel] == st["factor_batches"] and counts["btrsm"] == 0,
                  f"{kind} factor lane launched {kernel} {counts[kernel]} times for "
                  f"{st['factor_batches']} batches: {counts}")
            check(bitwise == F, f"{kind} engine sessions bitwise plan.factor: {bitwise}/{F}")
            check(builds == 0 and made == 0,
                  f"{kind}: {builds} kernel builds, {made} programs made after prewarm")
            eng_s = [first_s]
            for _ in range(4):
                t0 = time.perf_counter()
                for f in [eng.submit_factor(plan, Ah[i]) for i in range(F)]:
                    f.result(600)
                eng_s.append(time.perf_counter() - t0)
        seq_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            for i in range(F):
                plan.factor(Ah[i])
            torch.cuda.synchronize()
            seq_s.append(time.perf_counter() - t0)
        print(f"[engine 26] {kind}: {F / _median(eng_s):.1f} sessions/s through "
              f"submit_factor vs {F / _median(seq_s):.1f} sequential plan.factor (from "
              "host arrays; median of 5 legs each)", flush=True)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del sessions, refs
    torch.cuda.empty_cache()
    return total


def _gang_rounds(eng, fleet, bs, rounds: int):
    """Closed-loop rounds: each round one request per session (one
    `submit_many` frame), then wait; (answers of the last round,
    seconds)."""
    t0 = time.perf_counter()
    xs = None
    for _ in range(rounds):
        futs = eng.submit_many([(s, b, None) for s, b in zip(fleet, bs)])
        xs = [f.result(600) for f in futs]
    return xs, time.perf_counter() - t0


def phase_engine_gang() -> dict:
    """(27) Gang-resident stacks at bench_engine.py --gang's shape: 16
    (256, 256) f32 sessions, v=128, stack_sessions with max_stack 16,
    widths 1,1,1,2, 8 rounds of one request per session; then 4 members
    drifted by rank 4 under a guarded engine. One K3 launch per stacked
    dispatch, every stack exclusion 0, answers within the bars, no kernel
    build and no program made after prewarm, the first K3 round at each
    shape of every engine (the plain stacked round; the fused-probe round
    of a guarded engine on the clean fleet; the Woodbury base round of the
    drifted one) held against its plain version, a slot's answer bitwise invariant to the stack bucket
    and the pad slots and bitwise the session's own solve; solves/s beside
    the per-session dispatch."""
    import numpy as np

    from conflux_tpu_torch import profiler, serve
    from conflux_tpu_torch.batched import stack_trees
    from conflux_tpu_torch.engine import ServeEngine
    from conflux_tpu_torch.ops import hopper_kernels
    from conflux_tpu_torch.resilience import HealthPolicy

    n, S, rounds = 256, 16, 8
    serve.clear_plans()
    plan = serve.FactorPlan.create((n, n), torch.float32, v=128)
    A = _systems(S, n, 27)
    fleet = [plan.factor(A[i]) for i in range(S)]
    rng = np.random.default_rng(27)
    bs = [rng.standard_normal((n,) if GANG_WIDTHS[i % 4] == 1 else (n, 2))
          .astype(np.float32) for i in range(S)]
    total: dict = {}

    def run(tag, eng, Amat):
        with _held_to_plain(f"engine 27 {tag}", ("btrsm",)):
            eng.prewarm(fleet[0], widths=(1, 2), stacks=(S,), update_ranks=(4,))
            builds0, made0 = profiler.compile_count(), _programs(plan)
            torch.cuda.synchronize()
            hopper_kernels.reset_launches()
            xs, _s = _gang_rounds(eng, fleet, bs, rounds)
            torch.cuda.synchronize()
        counts = dict(hopper_kernels.LAUNCHES)
        st = eng.stats()
        builds = profiler.compile_count() - builds0
        made = _programs(plan) - made0
        worst = 0.0
        for i, x in enumerate(xs):
            xx = torch.from_numpy(x).cuda().reshape(n, -1)
            bb = torch.from_numpy(bs[i]).cuda().reshape(n, -1)
            worst = max(worst, float((Amat[i] @ xx - bb).abs().max()))
        excl = st["stack_exclusions"]
        secs = _gang_rounds(eng, fleet, bs, rounds)[1]  # timed: the held leg waits
        print(f"[engine 27] {tag}: {st['gang_batches']} stacked dispatches of "
              f"{st['batches']} (gang mean {st['gang_coalesced_mean']:.1f} requests), "
              f"launches {counts}; exclusions {excl}; max |A x - b| {worst:.3e}; after "
              f"prewarm {builds} kernel builds, {made} programs made; "
              f"{S * rounds / secs:.1f} solves/s (the next leg)", flush=True)
        check(st["gang_batches"] == rounds == st["batches"],
              f"{tag}: {st['gang_batches']} stacked of {st['batches']} batches")
        check(counts["btrsm"] == st["gang_batches"], f"{tag}: K3 {counts['btrsm']} "
              f"launches for {st['gang_batches']} stacked dispatches")
        check(all(v == 0 for v in excl.values()), f"{tag}: exclusions {excl}")
        check(worst < SOLVE_TOL, f"{tag}: max |A x - b| {worst:.3e}")
        check(builds == 0 and made == 0,
              f"{tag}: {builds} kernel builds, {made} programs made after prewarm")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return secs

    with ServeEngine(max_batch_delay=0.002, stack_sessions=True, max_stack=S) as eng:
        gang_s = [run("plain", eng, A)]
        gang_s += [_gang_rounds(eng, fleet, bs, rounds)[1] for _ in range(4)]
        g = eng.lanes[0]._gangs[id(plan)]
        with g._lock:
            F16 = g._F
            si = g.slot_of(fleet[0])
        # bucket and pad invariance: slot si of the resident 16-stack
        # against a 2-stack with another session in the pad slot; and the
        # session's own solve
        b1 = torch.from_numpy(bs[0].reshape(n, -1)).cuda()
        big = torch.zeros((S, n, b1.shape[-1]), device="cuda")
        big[si] = b1
        x16 = plan._stacked_solve_fn(S, b1.shape[-1])(F16, None, big)[si]
        F2 = stack_trees([fleet[0].factors, fleet[5].factors])
        two = torch.randn((2, n, b1.shape[-1]), device="cuda")
        two[0] = b1
        x2 = plan._stacked_solve_fn(2, b1.shape[-1])(F2, None, two)[0]
        solo = fleet[0].solve(b1)
        inv, own = torch.equal(x16, x2), torch.equal(x16, solo)
        print(f"[engine 27] slot bitwise across buckets 16 and 2 with other pad contents "
              f"{inv}; stacked answer bitwise the session's own solve {own}", flush=True)
        check(inv, "gang slot answer depends on the stack bucket or the pad slots")
        check(own, "gang slot answer is not bitwise the session's own solve")
    with ServeEngine(max_batch_delay=0.002) as eng:
        eng.prewarm(fleet[0], widths=(1, 2))
        solo_s = [_gang_rounds(eng, fleet, bs, rounds)[1] for _ in range(5)]
    print(f"[engine 27] {S * rounds / _median(gang_s):.1f} solves/s stacked vs "
          f"{S * rounds / _median(solo_s):.1f} per-session dispatch (median of 5 legs of "
          f"{rounds} rounds)", flush=True)
    # the checked gang on the clean fleet: each slot's verdict from the
    # same K3 launch (the fused probe)
    with ServeEngine(max_batch_delay=0.002, stack_sessions=True, max_stack=S,
                     health=HealthPolicy()) as eng:
        run("checked", eng, A)
    # drift: rank 4 on four members, under a guarded (checked) gang
    A1 = A.clone()
    for i in (1, 4, 9, 14):
        U = torch.from_numpy(0.01 * rng.standard_normal((n, 4))).cuda().float()
        V = torch.from_numpy(0.01 * rng.standard_normal((n, 4))).cuda().float()
        fleet[i].update(U, V)
        A1[i] = A[i] + U @ V.mT
    with ServeEngine(max_batch_delay=0.002, stack_sessions=True, max_stack=S,
                     health=HealthPolicy()) as eng:
        run("drift rank 4, checked", eng, A1)
        check(eng.lanes[0]._gangs[id(plan)].stats()["rank_bucket"] == 4,
              "the gang's rank bucket is not 4")
    del fleet
    torch.cuda.empty_cache()
    return total


# --------------------------------------------------------------------------- #
# 28-30: tiered residency, the fleet checkpoint and the adaptive controller
# --------------------------------------------------------------------------- #


def _zipf_picks(F: int, R: int, seed: int, a: float = 1.1):
    """bench_engine.py --tier's trace: R session ids of a fleet of F with
    Zipf(a) popularity, decoupled from the ids; and the generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pmf = 1.0 / np.arange(1, F + 1) ** a
    pmf /= pmf.sum()
    order = rng.permutation(F)
    return [int(i) for i in order[rng.choice(F, size=R, p=pmf)]], rng


@contextlib.contextmanager
def _held_revivals():
    """Inside the block, every revived session's first K3 round (a round on
    a nonzero rhs) is held against `btrsm_pair_plain` on the same card
    tensors: revivals (an h2d implant or a refactor) mark the session's
    first factor tensor, and the first `btrsm_pair` launch on it compares.
    Yields (records, counts): records [(rel_fro, max_abs)], counts
    {'revived', 'unsolved'} filled at exit."""
    import threading

    from conflux_tpu_torch import tier
    from conflux_tpu_torch.ops import hopper_kernels as hk

    pending: set = set()
    recs: list = []
    counts = {"revived": 0, "unsolved": 0}
    lock = threading.Lock()
    implant, refactor, pair = tier._implant, tier.ResidentSet._revive_refactor, hk.btrsm_pair

    def mark(session):
        with lock:
            pending.add(session._factors[0].data_ptr())
            counts["revived"] += 1

    def held_implant(session, leaves, meta, **kw):
        implant(session, leaves, meta, **kw)
        mark(session)

    def held_refactor(self, session, leaves, meta):
        refactor(self, session, leaves, meta)
        mark(session)

    def held_pair(T, Dl, Du, b, *, perm=None, trans_back=False, wA=None):
        got = pair(T, Dl, Du, b, perm=perm, trans_back=trans_back, wA=wA)
        with lock:
            hit = T.data_ptr() in pending
        if hit and bool(b.any()):
            with lock:
                pending.discard(T.data_ptr())
            want = hk.btrsm_pair_plain(T, Dl, Du, b, perm, trans_back, wA)
            x, xw = (got, want) if wA is None else (got[0], want[0])
            recs.append((rel_fro(x, xw), float((x - xw).abs().max())))
        return got

    tier._implant, tier.ResidentSet._revive_refactor, hk.btrsm_pair = (
        held_implant, held_refactor, held_pair)
    try:
        yield recs, counts
    finally:
        tier._implant, tier.ResidentSet._revive_refactor, hk.btrsm_pair = implant, refactor, pair
        counts["unsolved"] = len(pending)


def _check_revivals(tag: str, recs: list, counts: dict) -> None:
    worst = max((r[0] for r in recs), default=0.0)
    print(f"[{tag}] {counts['revived']} revivals: the first K3 round of {len(recs)} held "
          f"against btrsm_pair_plain (worst rel_fro {worst:.2e}, bound {K3_TOL:g}; "
          f"{counts['unsolved']} not solved again)", flush=True)
    check(len(recs) > 0 and len(recs) + counts["unsolved"] == counts["revived"],
          f"{tag}: {len(recs)} held + {counts['unsolved']} unsolved != {counts['revived']} "
          "revivals")
    check(worst <= K3_TOL, f"{tag}: a revived session's K3 round disagrees with its plain "
          f"version (rel_fro {worst:.2e})")


def _tier_counts(h0: dict) -> dict:
    from conflux_tpu_torch import tier

    h1 = tier.tier_stats()
    return {k: h1[k] - h0.get(k, 0) for k in ("spills_host", "spills_disk", "revives_h2d",
                                               "revives_disk", "revives_refactor")}


def _fault_pcts(ts: dict) -> str:
    return (f"fault-in p50 {ts['fault_in_p50_ms']:.3f} ms, p95 {ts['fault_in_p95_ms']:.3f} "
            f"ms, p99 {ts['fault_in_p99_ms']:.3f} ms (host clock)")


def phase_tier() -> dict:
    """(28) Tiered residency (cell n). First bench_engine.py --tier's shape
    (BENCH_WORKINGSET.json): 32 (256, 256) f32 LU sessions, v=128, over a
    device tier of 4 sessions (count and byte caps), 128 Zipf(1.1)
    requests by direct `session.solve`, beside the always-refactor LRU
    loop (at most 4 live sessions, `plan.factor` per miss). Then at full
    width: 128 (1024, 1024) f32 LU sessions, v=256, a byte cap of 16
    sessions, 96 host sessions at most (the rest demoted to a temporary
    disk_dir), 1024 width-1 Zipf(1.1) requests through
    `ServeEngine(residency=...)`. Every answer bitwise the session's answer
    before it was ever spilled, the byte high-water at most the cap, every
    revived session's first K3 round held against its plain version, no
    build and no program after prewarm; then four members drifted past
    `revive_refactor_rank`, spilled and touched together revive through
    the factor lane (K4 launches == the lane's factor batches) and hold
    max |(A + U V^T) x - b| < SOLVE_TOL; and the host time of four spill
    waves of 8 sessions. Each leg clears the tier counters and the
    fault-in latency window before its traffic, so its percentiles are its
    own; every leg's kernel launches go into the returned total."""
    import threading

    import numpy as np

    from conflux_tpu_torch import profiler, serve, tier
    from conflux_tpu_torch.engine import ServeEngine
    from conflux_tpu_torch.ops import hopper_kernels
    from conflux_tpu_torch.tier import ResidentSet

    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # --- BENCH_WORKINGSET.json's shape --------------------------------- #
    n, F, C, R = 256, 32, 4, 128
    serve.clear_plans()
    plan = serve.FactorPlan.create((n, n), torch.float32, v=128)
    A = _systems(F, n, 28)
    picks, rng = _zipf_picks(F, R, 28)
    b = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).cuda()
    hopper_kernels.reset_launches()
    x_want = [plan.factor(A[i]).solve(b) for i in range(F)]
    per = plan.factor(A[0]).nbytes

    def baseline():
        live: dict = {}
        lru: list = []
        t0 = time.perf_counter()
        for sid in picks:
            s = live.get(sid)
            if s is None:
                if len(live) >= C:
                    live.pop(lru.pop(0))
                s = live[sid] = plan.factor(A[sid])
            else:
                lru.remove(sid)
            lru.append(sid)
            s.solve(b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    fleet = [plan.factor(A[i]) for i in range(F)]
    rs = ResidentSet(max_sessions=C, max_bytes=C * per, evict_batch=C // 2)
    rs.adopt(*fleet)

    def tiered():
        t0 = time.perf_counter()
        xs = [fleet[sid].solve(b) for sid in picks]
        torch.cuda.synchronize()
        return time.perf_counter() - t0, xs

    baseline()
    tiered()
    tier.clear_tier()
    builds0, made0, h0 = profiler.compile_count(), _programs(plan), tier.tier_stats()
    with _held_revivals() as (recs, counts):
        _t, xs = tiered()
    _check_revivals("tier 28 bench", recs, counts)
    bitwise = sum(int(torch.equal(x, x_want[sid])) for x, sid in zip(xs, picks))
    t_base, t_tier = [], []
    for rep in range(3):  # interleaved, alternating order
        legs = (baseline, lambda: tiered()[0])
        for leg in (legs if rep % 2 == 0 else legs[::-1]):
            (t_base if leg is baseline else t_tier).append(leg())
    st, moved, ts = rs.stats(), _tier_counts(h0), tier.tier_stats()
    builds, made = profiler.compile_count() - builds0, _programs(plan) - made0
    print(f"[tier 28] bench shape: {F} ({n}, {n}) sessions over {C} device slots, {R} "
          f"Zipf(1.1) requests: bitwise the never-spilled answers {bitwise}/{R}; "
          f"{R / _median(t_tier):.1f} solves/s tiered vs {R / _median(t_base):.1f} "
          f"always-refactor LRU (x{_median(t_base) / _median(t_tier):.2f}, median of 3 "
          f"interleaved legs); {moved}; {_fault_pcts(ts)} over the 4 tiered runs; "
          f"device bytes high-water "
          f"{st['device_bytes_high_water']} (cap {C * per}); after warm-up {builds} "
          f"kernel builds, {made} programs made", flush=True)
    check(bitwise == R, f"tier 28 bench: {bitwise}/{R} answers bitwise")
    check(st["device_bytes_high_water"] <= C * per and st["resident_high_water"] <= C,
          f"tier 28 bench: high-water {st['device_bytes_high_water']} B, "
          f"{st['resident_high_water']} sessions over the cap")
    check(builds == 0 and made == 0, f"tier 28 bench: {builds} builds, {made} programs")
    add(dict(hopper_kernels.LAUNCHES))
    del fleet, rs, x_want, A

    # --- full width: 128 (1024, 1024) sessions through the engine ------ #
    n, F, R = 1024, 128, 1024
    serve.clear_plans()
    plan = serve.FactorPlan.create((n, n), torch.float32, v=256)
    hopper_kernels.reset_launches()
    A_host, fleet = [], []
    for c in range(F // 16):
        A16 = _systems(16, n, 2800 + c)
        A_host.append(A16.cpu().numpy())
        fleet += [plan.factor(A16[i].clone()) for i in range(16)]
    A_host = np.concatenate(A_host)
    picks, rng = _zipf_picks(F, R, 2828)
    b1 = rng.standard_normal(n).astype(np.float32)
    bd = torch.from_numpy(b1).cuda()
    x_want = [s.solve(bd).cpu().numpy() for s in fleet]
    nb = fleet[0].nbytes
    cap = 16 * nb
    disk = tempfile.TemporaryDirectory(prefix="tier28-")
    rs = ResidentSet(max_bytes=cap, host_max_sessions=96, disk_dir=disk.name, evict_batch=4)
    t0 = time.perf_counter()
    rs.adopt(*fleet)
    adopt_s = time.perf_counter() - t0
    st0 = rs.stats()
    print(f"[tier 28] {F} ({n}, {n}) sessions of {nb / 2 ** 20:.2f} MiB "
          f"({F * nb / 2 ** 30:.2f} GiB in all) adopted in {adopt_s:.2f} s: "
          f"{st0['resident_sessions']} resident, {st0['host_sessions']} host, "
          f"{st0['disk_sessions']} disk", flush=True)
    with ServeEngine(max_batch_delay=0.002, residency=rs, max_coalesce_width=32) as eng:
        eng.prewarm(fleet[0], widths=(1, 2, 4, 8, 16, 32), factor_batches=(1, 2, 4))
        torch.cuda.synchronize()
        tier.clear_tier()
        builds0, made0, h0 = profiler.compile_count(), _programs(plan), tier.tier_stats()
        b0 = eng.stats()["batches"]
        k3_0 = hopper_kernels.LAUNCHES["btrsm"]
        with _held_revivals() as (recs, counts):
            futs = [eng.submit(fleet[sid], b1) for sid in picks]
            xs = [f.result(600) for f in futs]
        _check_revivals("tier 28", recs, counts)
        k3 = hopper_kernels.LAUNCHES["btrsm"] - k3_0
        batches = eng.stats()["batches"] - b0
        bitwise = sum(int(np.array_equal(x, x_want[sid])) for x, sid in zip(xs, picks))
        t0 = time.perf_counter()  # timed: the held leg above waits for the card
        for f in [eng.submit(fleet[sid], b1) for sid in picks]:
            f.result(600)
        eng_s = time.perf_counter() - t0
        st, moved = eng.stats(), _tier_counts(h0)
        ts = tier.tier_stats()
        builds, made = profiler.compile_count() - builds0, _programs(plan) - made0
        print(f"[tier 28] {R} requests twice through the engine: bitwise the never-spilled "
              f"answers {bitwise}/{R}; {batches} batches, {k3} K3 launches; {moved}; "
              f"{_fault_pcts(ts)} over these {2 * R} requests; device bytes "
              f"high-water {st['tier']['device_bytes_high_water']} (cap {cap}); "
              f"memory_allocated {st['tier']['memory_allocated'] / 2 ** 30:.3f} GiB; "
              f"after prewarm {builds} kernel builds, {made} programs made", flush=True)
        check(bitwise == R, f"tier 28: {bitwise}/{R} engine answers bitwise")
        check(k3 == batches, f"tier 28: {k3} K3 launches for {batches} batches")
        check(st["tier"]["device_bytes_high_water"] <= cap,
              f"tier 28: device bytes high-water {st['tier']['device_bytes_high_water']} "
              f"over the cap {cap}")
        check(moved["spills_disk"] > 0 and moved["revives_disk"] > 0,
              f"tier 28: the disk tier was not exercised: {moved}")
        check(builds == 0 and made == 0, f"tier 28: {builds} builds, {made} programs")
        # the always-refactor LRU loop at this width: 16 live sessions
        live: dict = {}
        lru: list = []
        t0 = time.perf_counter()
        for sid in picks:
            s = live.get(sid)
            if s is None:
                if len(live) >= 16:
                    live.pop(lru.pop(0))
                s = live[sid] = plan.factor(A_host[sid])
            else:
                lru.remove(sid)
            lru.append(sid)
            s.solve(bd).cpu()
        base_s = time.perf_counter() - t0
        del live
        print(f"[tier 28] {R / eng_s:.1f} solves/s through the tiered engine vs "
              f"{R / base_s:.1f} always-refactor LRU (16 live sessions, plan.factor per "
              "miss, answer to the host), one leg each", flush=True)
        # revive-by-refactor: four members drifted past the rank, spilled,
        # touched together from four client threads
        four = [fleet[i] for i in (3, 17, 42, 99)]
        Us = []
        for i, s in enumerate(four):
            U = torch.from_numpy(0.01 * rng.standard_normal((n, 8))).cuda().float()
            V = torch.from_numpy(0.01 * rng.standard_normal((n, 8))).cuda().float()
            s.update(U, V)
            Us.append((U, V))
        rs.revive_refactor_rank = 8
        rs.spill(*four)
        torch.cuda.synchronize()
        f0, h0 = eng.stats()["factor_batches"], tier.tier_stats()
        add(dict(hopper_kernels.LAUNCHES))
        hopper_kernels.reset_launches()
        gate = threading.Barrier(4)
        outs: dict = {}

        def touch(i):
            gate.wait(30)
            outs[i] = four[i].solve(bd)

        with _held_revivals() as (recs, counts):
            threads = [threading.Thread(target=touch, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            torch.cuda.synchronize()
        k4 = hopper_kernels.LAUNCHES["batched_lu"]
        fbatches = eng.stats()["factor_batches"] - f0
        moved = _tier_counts(h0)
        worst = 0.0
        for i, s in enumerate(four):
            U, V = Us[i]
            Ad = torch.from_numpy(A_host[fleet.index(s)]).cuda() + U @ V.mT
            worst = max(worst, float((Ad @ outs[i] - bd).abs().max()))
        print(f"[tier 28] revive-by-refactor: 4 members at drift rank 8 (revive_refactor_rank "
              f"8) touched together: {moved['revives_refactor']} refactor revivals in "
              f"{fbatches} factor-lane batches, K4 launches {k4}; max |(A + U V^T) x - b| "
              f"{worst:.3e} (bar {SOLVE_TOL:g})", flush=True)
        _check_revivals("tier 28 refactor", recs, counts)
        check(moved["revives_refactor"] == 4, f"tier 28: {moved['revives_refactor']} refactor "
              "revivals of 4")
        check(k4 == fbatches and fbatches >= 1,
              f"tier 28: K4 launched {k4} times for {fbatches} factor batches")
        check(worst < SOLVE_TOL, f"tier 28: refactor revival max |(A + U V^T) x - b| {worst:.3e}")
        add(dict(hopper_kernels.LAUNCHES))
    # four spill waves of 8 sessions: the first allocates its pinned host
    # tensors, the later ones reuse the blocks torch's host allocator keeps
    hopper_kernels.reset_launches()
    waves = []
    eight = [plan.factor(A_host[i]) for i in range(8)]
    rsx = ResidentSet()
    rsx.adopt(*eight)
    for rep in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rsx.spill(*eight)
        waves.append(1e3 * (time.perf_counter() - t0))
        if rep % 2:
            rsx.revive_many(eight)
        else:
            for s in eight:
                rsx.fault_in(s)
    torch.cuda.synchronize()
    add(dict(hopper_kernels.LAUNCHES))
    print(f"[tier 28] a spill wave of 8 ({n}, {n}) sessions ({8 * nb / 2 ** 20:.0f} MiB, one "
          f"host sync): {[round(w, 3) for w in waves]} ms (host clock; first wave "
          "first)", flush=True)
    disk.cleanup()
    del fleet, eight, rs, rsx
    torch.cuda.empty_cache()
    return total


def phase_ckpt() -> dict:
    """(29) Checkpoint -> kill -> restore: `scripts/torch_ckpt_roundtrip.py`
    as two processes. The save builds 8 (1024, 1024) f32 sessions (plain,
    drifted, refine=1; two spilled to the host, two demoted to disk),
    records their answers and checkpoints at the engine's drain barrier,
    then a delta generation after 2 sessions drift (2 records written, 6
    carried); the restore, in a fresh process, rebuilds both generations
    through `engine.restore` and holds answers, verdicts, counters and drift
    ranks bitwise. Returns the two processes' kernel launches."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "torch_ckpt_roundtrip.py")
    total: dict = {}
    with tempfile.TemporaryDirectory(prefix="ckpt29-") as d:
        for flag in ("--save", "--restore"):
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, script, flag, d], capture_output=True,
                               text=True, timeout=600)
            lines = p.stdout.strip().splitlines()
            for line in lines:
                print(f"[ckpt 29] {line}", flush=True)
            if p.returncode != 0:
                print(p.stderr[-4000:], file=sys.stderr, flush=True)
            check(p.returncode == 0 and lines,
                  f"ckpt 29: {flag} exited {p.returncode}")
            doc = json.loads(lines[-1])
            check(doc["ok"], f"ckpt 29: {flag} reported {doc}")
            for k, v in doc["launches"].items():
                total[k] = total.get(k, 0) + v
            print(f"[ckpt 29] {flag} process: {time.perf_counter() - t0:.1f} s, launches "
                  f"{doc['launches']}", flush=True)
    check(total.get("btrsm", 0) > 0 and total.get("batched_lu", 0) > 0,
          f"ckpt 29: the round trip did not run K3 and K4: {total}")
    return total


def phase_controller() -> dict:
    """(30) The adaptive controller (cell o) on BENCH_ADAPTIVE.json's trace:
    a (32, 256, 256) f32 LU plan, v=128, 2 sessions, three regimes of 2 s
    (a width-1 ramp, a width-4 overload burst, a {2, 4, 8} width drift)
    under `AdaptiveController(slo_p99_ms=25, interval=0.25)` with its
    operating point persisted to a temporary file, then the same trace on
    one static engine (2 ms, 1024 pending). Checks: 12 ticks or more and no
    tick error, every width growth made only after `bucket_ready` with no
    build and no program made across the switch, a sample of answers
    bitwise the direct solves, every K3 round at a new shape held against
    its plain version. The p99 per regime is printed, not gated."""
    import threading

    import numpy as np

    from conflux_tpu_torch import profiler, serve
    from conflux_tpu_torch.control import AdaptiveController, ControlLimits
    from conflux_tpu_torch.engine import EngineSaturated, ServeEngine
    from conflux_tpu_torch.ops import hopper_kernels

    B, n, S, W, phase_s = 32, 256, 2, 32, 2.0
    serve.clear_plans()
    plan = serve.FactorPlan.create((B, n, n), torch.float32, v=128)
    sessions = [plan.factor(_systems(B, n, 300 + i)) for i in range(S)]
    rng = np.random.default_rng(30)

    def service_s(w, k=10):
        bw = torch.from_numpy(rng.standard_normal((B, n, w)).astype(np.float32)).cuda()
        for _ in range(3):
            sessions[0].solve(bw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            sessions[0].solve(bw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / k

    s1, s_wide = service_s(1), service_s(W)
    lam_cap = 2600.0  # bounds the submit loop's duty cycle
    lam0, lam1 = 0.2 / s1, 0.8 / s1
    mu_burst = (W // 4) / s_wide
    lam_burst = min(1.7 * mu_burst, lam_cap)
    lam_drift = min(0.35 / s1, lam_cap)
    arrivals = []  # (t, width)
    t = 0.0
    while t < phase_s:  # inhomogeneous ramp by thinning
        t += rng.exponential(1.0 / max(lam0, lam1))
        if t < phase_s and rng.random() < (lam0 + (lam1 - lam0) * t / phase_s) / max(lam0, lam1):
            arrivals.append((t, 1))
    t = phase_s
    while t < 2 * phase_s:
        t += rng.exponential(1.0 / lam_burst)
        if t < 2 * phase_s:
            arrivals.append((t, 4))
    t, i = 2 * phase_s, 0
    while t < 3 * phase_s:
        t += rng.exponential(1.0 / lam_drift)
        if t < 3 * phase_s:
            arrivals.append((t, (2, 4, 8)[i % 3]))
            i += 1
    pool = {w: [rng.standard_normal((B, n, w)).astype(np.float32) for _ in range(4)]
            for w in (1, 2, 4, 8)}
    with ServeEngine(max_batch_delay=0.0) as warm:
        warm.prewarm(sessions[0], widths=(1, 2, 4, 8, 16, 32))
    regimes = (("ramp", 0.0, phase_s), ("burst", phase_s, 2 * phase_s),
               ("drift", 2 * phase_s, 3 * phase_s))

    def run_leg(eng):
        done = [None] * len(arrivals)
        futs = [None] * len(arrivals)
        shed = 0
        for f in [eng.submit(sessions[0], pool[1][0]) for _ in range(8)]:
            f.result(300)
        base = time.perf_counter() + 0.05
        for idx, (at, w) in enumerate(arrivals):
            now = time.perf_counter() - base
            if at > now:
                time.sleep(at - now)
            try:
                fut = eng.submit(sessions[idx % S], pool[w][idx % 4])
            except EngineSaturated:
                shed += 1
                continue

            def cb(_f, idx=idx):
                done[idx] = time.perf_counter()

            futs[idx] = fut
            fut.add_done_callback(cb)
        for fut in futs:
            if fut is not None:
                fut.result(300)
        p99 = {}
        for name, lo, hi in regimes:
            xs = sorted(done[i] - (base + at) for i, (at, _w) in enumerate(arrivals)
                        if lo <= at < hi and futs[i] is not None and done[i] is not None)
            p99[name] = 1e3 * xs[min(len(xs) - 1, int(0.99 * len(xs)))] if xs else float("nan")
        return p99, shed, futs

    switches: list = []

    def watch_growth(eng):
        """Record each width growth the controller makes: (width, the
        bucket ready at the switch, kernel builds and programs made across
        the `set_knobs` call)."""
        set_knobs = eng.set_knobs

        def watched(**kw):
            w = kw.get("max_coalesce_width")
            if w is None or w <= eng.max_coalesce_width:
                return set_knobs(**kw)
            ready = plan.bucket_ready(width=w)
            b0, m0 = profiler.compile_count(), _programs(plan)
            out = set_knobs(**kw)
            switches.append((w, ready, profiler.compile_count() - b0, _programs(plan) - m0))
            return out

        eng.set_knobs = watched

    op_dir = tempfile.TemporaryDirectory(prefix="op30-")
    op_path = os.path.join(op_dir.name, "operating_point.json")
    os.environ["CONFLUX_TPU_TORCH_OPERATING_POINT"] = op_path
    ctl = AdaptiveController(slo_p99_ms=25.0, interval=0.25, persist=True,
                             limits=ControlLimits(max_coalesce_width=64))
    hopper_kernels.reset_launches()
    builds0 = profiler.compile_count()
    with _held_to_plain("controller 30", ("btrsm",)):
        eng = ServeEngine(max_batch_delay=0.0, max_pending=1024, max_coalesce_width=W,
                          controller=ctl)
        try:
            watch_growth(eng)
            p99_a, shed_a, futs = run_leg(eng)
            torch.cuda.synchronize()
        finally:
            eng.close(timeout=300)
        st = ctl.stats()
    sample = [i for i in range(0, len(arrivals), 50) if futs[i] is not None]
    bitwise = sum(int(np.array_equal(
        futs[i].result(0), sessions[i % S].solve(
            torch.from_numpy(pool[arrivals[i][1]][i % 4]).cuda()).cpu().numpy()))
        for i in sample)
    with ServeEngine(max_batch_delay=0.002, max_pending=1024, max_coalesce_width=W) as eng:
        p99_s, shed_s, _f = run_leg(eng)
    # a width growth on the card, driven through step() on a scripted
    # window (the live trace's p99 stays above the growth gate): the
    # background prewarm of bucket 64, then the switch, then 8 width-8
    # requests coalescing into one 64-wide K3 round
    live = len(switches)
    with _held_to_plain("controller 30 growth", ("btrsm",)) as k3g, \
            ServeEngine(max_batch_delay=0.05, max_coalesce_width=W) as eng:
        ctl2 = AdaptiveController(slo_p99_ms=25.0, interval=60.0, grow_after=1,
                                  limits=ControlLimits(max_coalesce_width=64))
        ctl2.attach(eng)
        watch_growth(eng)
        eng.solve(sessions[0], pool[1][0], timeout=300)  # an active target
        d = AdaptiveController.blank_delta()
        d["engine"].update(requests=50, completed=50, batches=20, coalesced_requests=50,
                           coalesced_mean=2.5, width_capped=10, latency_samples=50,
                           latency_p99_ms=2.0)
        ctl2._window = type("Scripted", (), {"delta": staticmethod(lambda: d)})()
        ctl2.step()  # launches the background prewarm of bucket 64
        ctl2._width_prewarm[1].join(300)
        ctl2.step()  # the switch
        wide = [pool[8][i % 4] for i in range(8)]
        got = [f.result(300) for f in [eng.submit(sessions[0], x) for x in wide]]
    grown = eng.max_coalesce_width
    wide_bitwise = sum(int(np.array_equal(g, sessions[0].solve(torch.from_numpy(x).cuda())
                                          .cpu().numpy())) for g, x in zip(got, wide))
    torch.cuda.synchronize()
    counts = dict(hopper_kernels.LAUNCHES)
    builds = profiler.compile_count() - builds0
    os.environ.pop("CONFLUX_TPU_TORCH_OPERATING_POINT", None)
    persisted = os.path.exists(op_path)
    op_dir.cleanup()
    fmt = ", ".join
    print(f"[controller 30] {len(arrivals)} arrivals over 3 regimes of {phase_s:g} s "
          f"(ramp {lam0:.0f}->{lam1:.0f}/s width 1, burst {lam_burst:.0f}/s width 4, drift "
          f"{lam_drift:.0f}/s widths 2/4/8): adaptive p99 "
          f"{fmt(f'{k} {v:.2f} ms' for k, v in p99_a.items())} ({shed_a} shed) vs static "
          f"2 ms/1024 p99 {fmt(f'{k} {v:.2f} ms' for k, v in p99_s.items())} ({shed_s} shed); "
          f"host clock, printed not gated", flush=True)
    print(f"[controller 30] {st['ticks']} ticks, {st['decisions']} decisions, "
          f"{st['errors']} tick errors; width growths (width, bucket_ready, builds, programs "
          f"across the switch) {switches} ({live} in the live trace, the rest scripted; cap "
          f"now {grown}, the coalesced width-64 answers bitwise the direct solves "
          f"{wide_bitwise}/8, K3 shapes held {sorted(k[1] for k in k3g)}); decisions tail "
          f"{[(d['knob'], d['old'], d['new']) for d in st['decisions_log'][-6:]]}; sampled "
          f"answers bitwise the direct solves {bitwise}/{len(sample)}; operating point "
          f"persisted {persisted}; launches {counts}; {builds} kernel builds", flush=True)
    check(st["ticks"] >= 12 and st["errors"] == 0,
          f"controller 30: {st['ticks']} ticks, {st['errors']} errors")
    check(switches and all(ready and b == 0 and m == 0 for _w, ready, b, m in switches),
          f"controller 30: a width growth moved onto a cold bucket or made a program: {switches}")
    check(grown == 64 and wide_bitwise == 8 and any(k[1][-1] == 64 for k in k3g),
          f"controller 30: cap {grown} after the scripted growth, {wide_bitwise}/8 wide answers "
          f"bitwise, K3 shapes {list(k3g)}")
    check(bitwise == len(sample) and sample, f"controller 30: {bitwise}/{len(sample)} sampled "
          "answers bitwise")
    check(persisted, "controller 30: the operating point was not persisted")
    check(builds == 0, f"controller 30: {builds} kernel builds")
    del sessions
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------- #
# 31: the serve fabric (`fabric.ServeFabric`) on the card
# --------------------------------------------------------------------------- #


def _script_module(relpath: str):
    """A script of the checkout (`scripts/torch_*.py`, `examples/torch_*.py`)
    as a module, named after its file: its functions serve the phases."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), relpath)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _add_counts(total: dict, counts: dict) -> None:
    for k in ("btrsm", "batched_lu", "batched_chol"):
        total[k] = total.get(k, 0) + int(counts.get(k, 0))


def _engines_sum(fab, key: str) -> int:
    return sum(h.core.eng.counters()[key] for h in fab._hosts.values()
               if not h._killed.is_set())


def phase_fabric() -> dict:
    """(31) The serve fabric on the card. (a) In process: `local_fabric(3)`
    with engines on the card, 12 sessions (six (32, 256, 256) f32 LU plans,
    v=128; four (1024, 1024) LU plans, v=256, two of them drifted by rank
    16 through `fabric.update`; two (32, 256, 256) SPD plans, v=128), K4
    and K5 launches equal to the factor-lane batches of the opens, 192
    requests of widths 1, 1, 2, 4 from 8 front threads, every answer
    bitwise the direct `session.solve` in this process, the drifted
    sessions' too (the Woodbury correction runs each column alone,
    `update.woodbury_apply`), and max |A x - b| < 1e-4,
    K3 once per batch with its first round at each shape held against
    `btrsm_pair_plain`; one host killed (every session bitwise as before,
    adopted == owned, 0 lost, the census conserved), one live migration
    bitwise, and a `replicas=2` fabric whose kill re-points (repointed ==
    adopted >= 1, 0 snapshot restores). (b) Worker processes:
    `scripts/torch_fabric_drill.py` as a subprocess (six workers on the
    card over the shm wire), its last line read as phase 29 reads its
    round trip's. Returns the launches of both legs."""
    import numpy as np

    from conflux_tpu_torch import fabric, resilience, serve
    from conflux_tpu_torch.fabric import FabricPolicy
    from conflux_tpu_torch.ops import hopper_kernels as hk

    drill = _script_module("scripts/torch_fabric_drill.py")
    t_phase = time.perf_counter()
    serve.clear_plans()
    sessions = drill.fleet("gpu", bigs=4)
    drifted = ("big-0", "big-1")
    total: dict = {}
    pol = FabricPolicy(heartbeat_interval=0.25, heartbeat_timeout=30.0, call_timeout=120.0)
    eng = {"max_batch_delay": 0.002}
    with tempfile.TemporaryDirectory(prefix="fabric31-") as root:
        fab = fabric.local_fabric(3, os.path.join(root, "a"), engine_kwargs=eng, policy=pol)
        try:
            fab.start()
            torch.cuda.synchronize()
            hk.reset_launches()
            mats = drill.open_fleet(fab, sessions, drifted=drifted)
            torch.cuda.synchronize()
            c_open = dict(hk.LAUNCHES)
            fbatches = _engines_sum(fab, "factor_batches")
            _add_counts(total, c_open)
            n_spd = sum(spec["kind"] == "chol" for _s, spec, _d in sessions)
            print(f"[fabric 31] opened {len(sessions)} sessions over 3 in-process hosts "
                  f"(owners {fab.owner_census()}): launches {c_open}, factor-lane batches "
                  f"{fbatches}", flush=True)
            check(c_open["batched_lu"] + c_open["batched_chol"] == fbatches
                  and c_open["batched_chol"] == n_spd
                  and c_open["batched_lu"] == len(sessions) - n_spd,
                  f"fabric 31: K4/K5 launches {c_open} != the opens' factor batches {fbatches}")
            # the same plans and matrices, factored and drifted in this process
            direct = {}
            for sid, spec, seed in sessions:
                d = drill.make_plan(spec).factor(drill.matrix(spec, seed))
                if sid in drifted:
                    d.update(*drill.drift(spec, seed))
                direct[sid] = d
            reqs = drill.trace(sessions, seed=31)
            b0 = _engines_sum(fab, "batches")
            torch.cuda.synchronize()
            hk.reset_launches()
            with _held_to_plain("fabric 31", ("btrsm",)):
                xs, dt = drill.run_traffic(fab, reqs)
                torch.cuda.synchronize()
            c_traffic = dict(hk.LAUNCHES)
            batches = _engines_sum(fab, "batches") - b0
            _add_counts(total, c_traffic)
            want = [direct[sid].solve(torch.from_numpy(b).cuda()).cpu().numpy()
                    for sid, b in reqs]
            # bitwise, drifted sessions too: the Woodbury correction runs
            # each column alone, whatever the engine's coalesced width
            same = [int(x.shape == w.shape and bool((x == w).all())) for x, w in zip(xs, want)]
            n_drift = sum(sid in drifted for sid, _b in reqs)
            bit_drift = sum(ok for ok, (sid, _b) in zip(same, reqs) if sid in drifted)
            worst = max(drill.residual(mats[sid], x, b) for (sid, b), x in zip(reqs, xs))
            print(f"[fabric 31] {len(reqs)} requests from {drill.THREADS} threads in "
                  f"{dt * 1e3:.1f} ms ({len(reqs) / dt:.1f} solves/s, host clock, with the "
                  f"plain comparisons): {batches} engine batches, launches {c_traffic}; "
                  f"bitwise the direct solve {sum(same)}/{len(reqs)} answers, of them the "
                  f"drifted sessions' {bit_drift}/{n_drift}; max |A x - b| {worst:.3e}",
                  flush=True)
            check(sum(same) == len(reqs), f"fabric 31: {sum(same)}/{len(reqs)} answers "
                  f"bitwise ({bit_drift}/{n_drift} of the drifted sessions')")
            check(worst < SOLVE_TOL, f"fabric 31: max |A x - b| {worst:.3e}")
            check(c_traffic["btrsm"] == batches and c_traffic["batched_lu"] == 0,
                  f"fabric 31: K3 launches {c_traffic} != engine batches {batches}")
            rhs, ref = drill.sequential_refs(fab, sessions, seed=32)
            hk.reset_launches()
            # kill the host holding a drifted session
            victim = fab.owner_of("big-0")
            owned = sorted(s for s in ref if fab.owner_of(s) == victim)
            fab._hosts[victim].kill()
            rec = drill.wait_recovery(fab, victim) or {}
            bad: list = []
            after = {sid: drill.answer_through_failover(fab, sid, rhs[sid], bad, "kill")
                     for sid in ref}
            same = sum(int(after[s] is not None and np.array_equal(after[s], ref[s]))
                       for s in ref)
            st = fab.stats()
            conserved = (st["sessions"] == len(sessions) and st["admitted_sessions"]
                         == st["sessions"] + st["lost_sessions"] + st["closed_sessions"])
            print(f"[fabric 31] killed {victim} ({len(owned)} sessions): recovery "
                  f"{rec.get('seconds', float('nan')) * 1e3:.1f} ms, adopted "
                  f"{rec.get('adopted')}, lost {rec.get('lost')}; bitwise as before "
                  f"{same}/{len(ref)}; census {st['sessions']} open of "
                  f"{st['admitted_sessions']} admitted", flush=True)
            check(not bad and same == len(ref), f"fabric 31: after the kill {same}/{len(ref)} "
                  f"bitwise {bad}")
            check(rec.get("adopted") == len(owned) and rec.get("lost") == 0 and conserved,
                  f"fabric 31: recovery {rec} for {len(owned)} owned, stats {st}")
            mig = next(s for s in ref if fab.owner_of(s) != victim and s != "big-0")
            src = fab.owner_of(mig)
            tgt = fab.migrate(mig)
            moved_ok = tgt != src and np.array_equal(np.asarray(fab.solve(mig, rhs[mig])),
                                                     ref[mig])
            print(f"[fabric 31] migrated {mig} {src} -> {tgt}: bitwise {moved_ok}", flush=True)
            check(moved_ok, f"fabric 31: migration of {mig} not bitwise")
            torch.cuda.synchronize()
            _add_counts(total, hk.LAUNCHES)
        finally:
            fab.close()
        # replicas=2: a kill re-points to the standbys
        ids = ["h0", "h1", "h2"]
        rsess = [(sid, spec, seed) for sid, (_n, spec, seed) in
                 zip(drill.spread_sids("rep", ids, 2), sessions[:6])]
        rpol = FabricPolicy(heartbeat_interval=0.25, heartbeat_timeout=30.0,
                            call_timeout=120.0, replicas=2)
        fab = fabric.local_fabric(3, os.path.join(root, "r"), engine_kwargs=eng, policy=rpol)
        try:
            fab.start()
            torch.cuda.synchronize()
            hk.reset_launches()
            drill.open_fleet(fab, rsess, drifted=())
            rrhs, rref = drill.sequential_refs(fab, rsess, seed=33)
            replicated = fab.stats()["replicated_sessions"]
            r0 = resilience.health_stats().get("fabric_snapshot_restores", 0)
            rvictim = fab.owner_of(rsess[0][0])
            rowned = [s for s in rref if fab.owner_of(s) == rvictim]
            fab._hosts[rvictim].kill()
            rrec = drill.wait_recovery(fab, rvictim) or {}
            restores = resilience.health_stats().get("fabric_snapshot_restores", 0) - r0
            bad = []
            rsame = 0
            for sid in rref:
                got = drill.answer_through_failover(fab, sid, rrhs[sid], bad, "replica")
                rsame += int(got is not None and np.array_equal(got, rref[sid]))
            torch.cuda.synchronize()
            _add_counts(total, hk.LAUNCHES)
            print(f"[fabric 31] replicas=2: {replicated}/{len(rsess)} replicated; killed "
                  f"{rvictim} ({len(rowned)} sessions): re-pointed {rrec.get('repointed')} "
                  f"of {rrec.get('adopted')} adopted in "
                  f"{rrec.get('seconds', float('nan')) * 1e3:.1f} ms, {restores} snapshot "
                  f"restores, lost {rrec.get('lost')}; bitwise {rsame}/{len(rref)}", flush=True)
            check(replicated == len(rsess) and rrec.get("repointed") == rrec.get("adopted")
                  == len(rowned) >= 1 and rrec.get("lost") == 0 and restores == 0,
                  f"fabric 31: replica kill {rrec}, {restores} snapshot restores")
            check(not bad and rsame == len(rref), f"fabric 31: replicas {rsame}/{len(rref)} "
                  f"bitwise {bad}")
        finally:
            fab.close()
    del direct
    torch.cuda.empty_cache()
    print(f"[fabric 31] in-process leg {time.perf_counter() - t_phase:.1f} s, launches "
          f"{total}", flush=True)
    # (b) the worker processes
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "torch_fabric_drill.py")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, script], capture_output=True, text=True, timeout=900)
    lines = p.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"[fabric 31] {line}", flush=True)
    if p.returncode != 0:
        print(p.stderr[-4000:], file=sys.stderr, flush=True)
    check(p.returncode == 0 and lines, f"fabric 31: the drill exited {p.returncode}")
    doc = json.loads(lines[-1])
    check(doc["ok"], f"fabric 31: the drill failed: {doc['failures']}")
    print(f"[fabric 31] drill {time.perf_counter() - t0:.1f} s: workers started in "
          f"{doc['start_s']} s, launches per worker {doc['launches']}, solves/s 2 workers "
          f"{doc['healthy']['solves_per_s_2_workers']} vs 1 worker "
          f"{doc['healthy']['solves_per_s_1_worker']}, SIGKILL recovery "
          f"{doc['kill']['recovery']['seconds'] * 1e3:.1f} ms, HostUnavailable in "
          f"{doc['kill']['host_unavailable_ms']} ms, shm leaks {doc['shm_leaks']}", flush=True)
    _add_counts(total, doc["launches_total"])
    print(f"[fabric 31] phase {time.perf_counter() - t_phase:.1f} s, launches {total}",
          flush=True)
    return total


# --------------------------------------------------------------------------- #
# 32-34: CONFLUX and CONFCHOX on a process grid
# --------------------------------------------------------------------------- #


def _grid_launches(tag: str, counts: dict, n: int) -> None:
    print(f"[{tag}]   launches {counts} over {n} factorizations: K1 {counts['gemm']} "
          f"({counts['gemm_tma']} TMA), K2 {counts['lu_block']}", flush=True)
    _only_tma(counts, tag)


def phase_dist_lu(kernel_ms: float) -> dict:
    """(32) bench.py's configuration on the card: `lu_factor_distributed` on
    a world-size-1 1x1x1 mesh at N=32768, v=1024, float32, on randn + 2 I
    from a seeded generator (`bench.py:93-96`), the input made anew before
    each run and donated as bench.py does. The warm-up holds the first K1
    and K2 call at each of the path's shapes against their plain versions;
    then 3 timed runs (mean ms, GFLOP/s at (2/3) N^3, beside phase 5's
    single-device route), the grid residual within residual_bound(N, f32),
    `lu_factor_steps` in two halves bitwise the uninterrupted run, and the
    miniapp's own route: -N 32768 -b 256 --p_grid 1,1,1 --validate (128
    supersteps: the distributed program). Returns the launches."""
    from conflux_tpu_torch.geometry import Grid3, LUGeometry
    from conflux_tpu_torch.lu.distributed import lu_factor_distributed, lu_factor_steps
    from conflux_tpu_torch.ops import hopper_kernels as hk
    from conflux_tpu_torch.parallel.mesh import make_mesh
    from conflux_tpu_torch.validation import lu_residual_distributed, residual_bound

    t_phase = time.perf_counter()
    N, v = 32768, 1024
    grid = Grid3(1, 1, 1)
    geom = LUGeometry.create(N, N, v, grid)
    mesh = make_mesh(grid)

    def make():
        gen = torch.Generator(device="cuda").manual_seed(0)
        A = torch.randn((N, N), generator=gen, device="cuda")
        A.diagonal().add_(2.0)
        return A

    torch.cuda.synchronize()
    hk.reset_launches()
    with _held_to_plain("dist 32"):
        out, perm = lu_factor_distributed(make(), geom, mesh, donate=True)
        torch.cuda.synchronize()
    del out, perm
    times = []
    for _ in range(3):
        A = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, perm = lu_factor_distributed(A, geom, mesh, donate=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = dict(hk.LAUNCHES)
    ms = sum(times) / len(times)
    print(f"[dist 32] N=32768 v=1024 f32 on 1x1x1 (bench.py's configuration): "
          f"{', '.join(f'{t:.1f}' for t in times)} ms, mean {ms:.1f} ms = "
          f"{2 / 3 * N ** 3 / ms / 1e6:.1f} GFLOP/s; phase 5's single-device route "
          f"{kernel_ms:.1f} ms (printed beside it, no claim)", flush=True)
    _grid_launches("dist 32", counts, 4)
    # the timed runs donated their inputs: the last one's is made anew
    res = lu_residual_distributed(make(), out, perm, geom, mesh)
    bar = residual_bound(N, torch.float32)
    print(f"[dist 32]   residual {res:.3e} <= {bar:.3e}", flush=True)
    check(math.isfinite(res) and res <= bar, f"dist 32: residual {res:.3e} > {bar:.3e}")
    # resume: two halves through the row-origin state, bitwise at Pz = 1
    hk.reset_launches()
    half = geom.n_steps // 2
    s1, o1, _ = lu_factor_steps(make(), geom, mesh, 0, half, donate=True)
    s2, _o2, perm2 = lu_factor_steps(s1, geom, mesh, half, geom.n_steps, orig=o1,
                                     donate=True)
    torch.cuda.synchronize()
    c_steps = dict(hk.LAUNCHES)
    same = torch.equal(s2, out) and torch.equal(perm2, perm)
    print(f"[dist 32]   lu_factor_steps [0, {half}) + [{half}, {geom.n_steps}): factors and "
          f"perm bitwise the uninterrupted run {same}; launches {c_steps}", flush=True)
    check(same, "dist 32: the resumed factorization is not bitwise the uninterrupted one")
    del s1, s2, out, A
    torch.cuda.empty_cache()
    lines, c_app = run_miniapp(["-N", "32768", "-b", "256", "--p_grid", "1,1,1", "-r", "1",
                                "--validate"])
    check(_field(lines, "_grid_") == "_grid_ 1x1x1 ranks=1 world=single transport=none "
          "device=cuda", f"dist 32: miniapp route {_field(lines, '_grid_')}")
    ms_app = float(_field(lines, "_result_").split(",")[8])
    res_app = float(_field(lines, "_residual_").split()[1])
    check(math.isfinite(res_app) and res_app <= bar,
          f"dist 32: miniapp residual {res_app:.3e} > {bar:.3e}")
    _only_tma(c_app, "dist 32")
    print(f"[dist 32]   miniapp -b 256 (128 supersteps): {ms_app:.1f} ms, residual "
          f"{res_app:.3e}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    for k in ("gemm", "gemm_tma", "lu_block"):
        counts[k] += c_steps[k] + c_app[k]
    torch.cuda.empty_cache()
    return counts


def phase_dist_chol() -> dict:
    """(33) CONFCHOX: `cholesky_factor_distributed` at 1x1x1, N=32768,
    v=1024, float32, on the tile-local SPD of `io.generate_spd_local` (the
    reference generator's scheme); the warm-up holds the first K1 call at
    each shape against its plain version, then 3 timed runs (GFLOP/s at
    (1/3) N^3) and the grid residual within residual_bound(N, f32).
    Returns the launches."""
    from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed
    from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3
    from conflux_tpu_torch.io import generate_spd_local
    from conflux_tpu_torch.ops import hopper_kernels as hk
    from conflux_tpu_torch.parallel.mesh import distribute_shards, make_mesh
    from conflux_tpu_torch.validation import cholesky_residual_distributed, residual_bound

    t_phase = time.perf_counter()
    N, v = 32768, 1024
    grid = Grid3(1, 1, 1)
    geom = CholeskyGeometry.create(N, v, grid)
    mesh = make_mesh(grid)
    import numpy as np

    shard = distribute_shards(lambda px, py: generate_spd_local(geom, px, py, dtype=np.float32),
                              mesh, shape=(1, 1, geom.Ml, geom.Nl), dtype=np.float32)
    torch.cuda.synchronize()
    hk.reset_launches()
    with _held_to_plain("dist 33", ("gemm",)):
        out = cholesky_factor_distributed(shard, geom, mesh)
        torch.cuda.synchronize()
    del out
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cholesky_factor_distributed(shard, geom, mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = dict(hk.LAUNCHES)
    ms = sum(times) / len(times)
    print(f"[dist 33] Cholesky N=32768 v=1024 f32 on 1x1x1: "
          f"{', '.join(f'{t:.1f}' for t in times)} ms, mean {ms:.1f} ms = "
          f"{N ** 3 / 3 / ms / 1e6:.1f} GFLOP/s", flush=True)
    _grid_launches("dist 33", counts, 4)
    check(counts["lu_block"] == 0, f"dist 33: Cholesky launched K2: {counts}")
    res = cholesky_residual_distributed(shard, out, geom, mesh)
    bar = residual_bound(N, torch.float32)
    print(f"[dist 33]   residual {res:.3e} <= {bar:.3e}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(math.isfinite(res) and res <= bar, f"dist 33: residual {res:.3e} > {bar:.3e}")
    del out, shard
    torch.cuda.empty_cache()
    return counts


def phase_dist_ranks() -> dict:
    """(34) Several ranks on the one card: threaded worlds on cuda:0 over
    the transport "staged" (gloo on host copies of the messages; NCCL
    refuses two ranks of one device), every computation on the card. LU
    at 2x2x1 (gather election) and 3x1x1 (butterfly) and Cholesky at 2x2x1,
    N=8192, v=256, float32 on the kernel routes: residuals within
    residual_bound(N, f32), every rank's perm identical; at N=2048, v=128,
    2x2x1, on the test matrix plus 8 times a random permutation (pivots
    won by a margin), the card's pivots equal the same code's on the
    CPU's threaded gloo world (the kernels' plain versions there). The
    times are a test
    of correctness on the card, not the paper's numbers: several ranks
    share one card and one host. Returns the launches."""
    import numpy as np

    from conflux_tpu_torch.cholesky.distributed import cholesky_factor_distributed
    from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, LUGeometry
    from conflux_tpu_torch.io import generate_spd_local
    from conflux_tpu_torch.lu.distributed import lu_factor_distributed
    from conflux_tpu_torch.ops import hopper_kernels as hk
    from conflux_tpu_torch.parallel.mesh import distribute_shards, run_threaded
    from conflux_tpu_torch.validation import (
        cholesky_residual_distributed,
        lu_residual_distributed,
        make_test_matrix,
        residual_bound,
    )

    t_phase = time.perf_counter()
    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    def lu_world(grid, N, v, election, device, transport, margin=0.0):
        geom = LUGeometry.create(N, N, v, grid)
        A = make_test_matrix(geom.M, geom.N, dtype=np.float32)
        if margin:  # a weighted random permutation: each pivot wins by a margin
            A[np.random.default_rng(1).permutation(geom.M), np.arange(geom.N)] += margin

        def fn(mesh):
            shard = distribute_shards(lambda px, py: geom.local_block(A, px, py), mesh,
                                      shape=(grid.Px, grid.Py, geom.Ml, geom.Nl),
                                      dtype=np.float32)
            mesh.barrier()
            t0 = time.perf_counter()
            out, perm = lu_factor_distributed(shard, geom, mesh, election=election)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize()
            mesh.barrier()
            dt = time.perf_counter() - t0
            res = lu_residual_distributed(shard, out, perm, geom, mesh)
            return perm.cpu(), res, dt * 1e3, dict(mesh.stats)

        return run_threaded(grid, fn, device=device, transport=transport, timeout=900.0)

    def report(tag, results, N, kind):
        perms = [r[0] for r in results if r[0] is not None]
        same = all(torch.equal(p, perms[0]) for p in perms)
        res = max(r[1] for r in results)
        bar = residual_bound(N, torch.float32)
        staged = sum(r[3]["staged_bytes"] for r in results)
        print(f"[ranks 34] {tag} {kind} N={N}: {max(r[2] for r in results):.1f} ms (a "
              f"correctness test: the ranks share one card and one host), residual "
              f"{res:.3e} <= {bar:.3e}, perm identical on every rank {same}; staged "
              f"{staged} bytes over {sum(r[3]['collectives'] for r in results)} collectives",
              flush=True)
        check(same and math.isfinite(res) and res <= bar, f"ranks 34: {tag} {kind} failed")

    for gridspec, election in (((2, 2, 1), "gather"), ((3, 1, 1), "butterfly")):
        grid = Grid3(*gridspec)
        hk.reset_launches()
        results = lu_world(grid, 8192, 256, election, "cuda", "staged")
        c = dict(hk.LAUNCHES)
        add(c)
        report(f"{grid} {election}", results, 8192, "LU")
        check(c["gemm"] > 0 and c["lu_block"] > 0, f"ranks 34: a kernel never ran: {c}")

    grid = Grid3(2, 2, 1)
    geom = CholeskyGeometry.create(8192, 256, grid)

    def chol(mesh):
        shard = distribute_shards(
            lambda px, py: generate_spd_local(geom, px, py, dtype=np.float32), mesh,
            shape=(grid.Px, grid.Py, geom.Ml, geom.Nl), dtype=np.float32)
        mesh.barrier()
        t0 = time.perf_counter()
        out = cholesky_factor_distributed(shard, geom, mesh)
        torch.cuda.synchronize()
        mesh.barrier()
        dt = time.perf_counter() - t0
        return None, cholesky_residual_distributed(shard, out, geom, mesh), dt * 1e3, \
            dict(mesh.stats)

    hk.reset_launches()
    results = run_threaded(grid, chol, device="cuda", transport="staged", timeout=900.0)
    c = dict(hk.LAUNCHES)
    add(c)
    report(f"{grid}", results, 8192, "Cholesky")
    check(c["gemm"] > 0, f"ranks 34: Cholesky never ran K1: {c}")

    # the card's pivots against the CPU world's, at N=2048, v=128, on a
    # matrix whose pivots win by a margin: the test matrix alone has
    # float32-level near-ties at this size (its float32 library route
    # elects other rows than its float64 one from step 4 on), which the
    # card's and the CPU's products, summing in other orders, may break
    # either way
    hk.reset_launches()
    card = lu_world(grid, 2048, 128, "gather", "cuda", "staged", margin=8.0)
    add(dict(hk.LAUNCHES))
    cpu = lu_world(grid, 2048, 128, "gather", "cpu", "gloo", margin=8.0)
    same = torch.equal(card[0][0], cpu[0][0])
    print(f"[ranks 34] {grid} N=2048 v=128 (test matrix + 8 P): the card's pivots equal the "
          f"CPU threaded world's {same} (residuals {card[0][1]:.3e} on the card, "
          f"{cpu[0][1]:.3e} on the CPU); "
          f"phase {time.perf_counter() - t_phase:.1f} s, launches {total}", flush=True)
    check(same, "ranks 34: the card's pivots differ from the CPU world's")
    torch.cuda.empty_cache()
    return total


# --------------------------------------------------------------------------- #
# 35-36: distributed QR and least squares on the process grid
# --------------------------------------------------------------------------- #


def _rel_max(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x.double() - ref.double()).abs().max() / ref.double().abs().max())


def phase_dist_qr() -> dict:
    """(35) `qr_factor_distributed` at full width on a world-size-1 1x1x1
    mesh: M = N = 32768, v = 1024, f32, randn from a seeded generator. The
    warm-up holds the first K1 call at each of the path's shapes against
    its plain version and counts K1 against `gemm_launches`; then 2 timed
    runs (ms, TFLOP/s at 2MN^2 - 2N^3/3), `qr_residual_distributed` within
    residual_bound(N, f32); at N=16384 lookahead bitwise the plain loop and
    `qr_factor_steps` in two halves bitwise the uninterrupted run. Tall:
    `tsqr_distributed` and `cholesky_qr2_distributed` at Px = 1 on
    (1048576, 256), `lstsq_distributed` and `qr_lstsq_distributed` at
    (32768, 1024) f32 and f64 against `torch.linalg.lstsq` (1e-4, 1e-9,
    phase 24's bars). Native `LUGeometry.scatter`/`gather` of the N=32768
    f32 matrix bitwise the numpy path, both host times. Returns the
    launches."""
    import numpy as np

    from conflux_tpu_torch import native, solvers
    from conflux_tpu_torch.cli.qr_miniapp import _tall_residuals
    from conflux_tpu_torch.geometry import Grid3, LUGeometry
    from conflux_tpu_torch.ops import hopper_kernels as hk
    from conflux_tpu_torch.parallel.mesh import make_mesh
    from conflux_tpu_torch.qr.distributed import (
        cholesky_qr2_distributed,
        gemm_launches,
        qr_factor_distributed,
        qr_factor_steps,
        tsqr_distributed,
    )
    from conflux_tpu_torch.validation import qr_residual_distributed, residual_bound

    t_phase = time.perf_counter()
    grid = Grid3(1, 1, 1)
    mesh = make_mesh(grid)
    gen = torch.Generator(device="cuda")

    def randn(*shape, seed, dtype=torch.float32):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    N, v = 32768, 1024
    geom = LUGeometry.create(N, N, v, grid)
    A = randn(N, N, seed=35)
    torch.cuda.synchronize()
    hk.reset_launches()
    with _held_to_plain("qr 35", ("gemm",)):
        Q, R = qr_factor_distributed(A, geom, mesh)
        torch.cuda.synchronize()
    warm = dict(hk.LAUNCHES)
    want = gemm_launches(geom)
    print(f"[qr 35] warm-up K1 launches {warm['gemm']} ({warm['gemm_tma']} TMA), predicted "
          f"{want} a factorization", flush=True)
    check(warm["gemm"] == want, f"qr 35: K1 launched {warm['gemm']} times, not {want}")
    del Q, R
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Q, R = qr_factor_distributed(A, geom, mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = dict(hk.LAUNCHES)
    check(counts["gemm"] == 3 * want, f"qr 35: K1 {counts['gemm']} over 3 runs, not {3 * want}")
    _only_tma(counts, "qr 35")
    ms = sum(times) / len(times)
    print(f"[qr 35] qr_factor_distributed M=N=32768 v=1024 f32 on 1x1x1: "
          f"{', '.join(f'{t:.1f}' for t in times)} ms, mean {ms:.1f} ms = "
          f"{_qr_flops(N, N) / ms / 1e9:.2f} TFLOP/s at 2MN^2 - 2N^3/3 ({CARD})", flush=True)
    t0 = time.perf_counter()
    rec, orth = qr_residual_distributed(A, Q, R, geom, mesh)
    bar = residual_bound(N, torch.float32)
    print(f"[qr 35]   qr_residual_distributed: reconstruction {rec:.3e}, orth {orth:.3e} "
          f"<= {bar:.3e} ({(time.perf_counter() - t0) * 1e3:.1f} ms, {CARD})", flush=True)
    check(rec <= bar and orth <= bar, f"qr 35: residuals {rec:.3e} {orth:.3e} > {bar:.3e}")
    del A, Q, R
    torch.cuda.empty_cache()

    # lookahead and resume, bitwise within the port, at N=16384
    Nh = 16384
    gh = LUGeometry.create(Nh, Nh, v, grid)
    Ah = randn(Nh, Nh, seed=36)
    hk.reset_launches()
    Qa, Ra = qr_factor_distributed(Ah, gh, mesh)
    Qb, Rb = qr_factor_distributed(Ah, gh, mesh, lookahead=True)
    la_same = torch.equal(Qa, Qb) and torch.equal(Ra, Rb)
    la_diff = 0.0 if la_same else max(_rel_max(Qb, Qa), _rel_max(Rb, Ra))
    del Qb, Rb
    half = gh.Nt // 2
    Qs, Rs = qr_factor_steps(Ah, gh, mesh, 0, half)
    Qs, Rs = qr_factor_steps(Qs, gh, mesh, half, gh.Nt, R=Rs, donate=True)
    torch.cuda.synchronize()
    steps_same = torch.equal(Qs, Qa) and torch.equal(Rs, Ra)
    c16 = dict(hk.LAUNCHES)
    want16 = 2 * gemm_launches(gh) + gemm_launches(gh, 8, 0, half) + gemm_launches(gh, 8, half)
    print(f"[qr 35]   N=16384: lookahead bitwise the plain loop {la_same} (max rel diff "
          f"{la_diff:.2e}); qr_factor_steps [0, {half}) + [{half}, {gh.Nt}) bitwise {steps_same};"
          f" K1 {c16['gemm']} launches, predicted {want16}", flush=True)
    check(la_same, "qr 35: lookahead is not bitwise the plain loop")
    check(steps_same, "qr 35: the resumed factorization is not bitwise the uninterrupted one")
    check(c16["gemm"] == want16, f"qr 35: N=16384 K1 {c16['gemm']}, not {want16}")
    counts["gemm"] += c16["gemm"]
    counts["gemm_tma"] += c16["gemm_tma"]
    del Ah, Qa, Ra, Qs, Rs
    torch.cuda.empty_cache()

    # tall-skinny at Px = 1, and the least-squares solves
    hk.reset_launches()
    T = randn(1048576, 256, seed=37)
    bar_t = residual_bound(256, torch.float32)
    for name, fn in (("tsqr_distributed", tsqr_distributed),
                     ("cholesky_qr2_distributed", cholesky_qr2_distributed)):
        Qt, Rt = fn(T, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Qt, Rt = fn(T, mesh)
        torch.cuda.synchronize()
        tms = (time.perf_counter() - t0) * 1e3
        rec_t, orth_t = _tall_residuals(T, Qt, Rt, mesh)
        print(f"[qr 35]   {name} (1048576, 256) Px=1: {tms:.1f} ms ({CARD}), "
              f"reconstruction {rec_t:.3e}, orth {orth_t:.3e} <= {bar_t:.3e}", flush=True)
        check(rec_t <= bar_t and orth_t <= bar_t, f"qr 35: {name} residuals")
    del T, Qt, Rt
    lg = LUGeometry.create(32768, 1024, 1024, grid)
    for dt, tol in ((torch.float32, 1e-4), (torch.float64, 1e-9)):
        G = randn(32768, 1024, seed=38, dtype=dt)
        b = randn(32768, 2, seed=39, dtype=dt)
        ref = torch.linalg.lstsq(G, b).solution
        x = solvers.lstsq_distributed(G, mesh, b)
        Qg, Rg = qr_factor_distributed(G, lg, mesh, backend="xla" if dt == torch.float64
                                       else "kernel")
        y = solvers.qr_lstsq_distributed(Qg, Rg, lg, mesh, b)
        ex, ey = _rel_max(x, ref), _rel_max(y, ref)
        print(f"[qr 35]   lstsq_distributed / qr_lstsq_distributed (32768, 1024) "
              f"{str(dt)[6:]}: max rel to torch.linalg.lstsq {ex:.2e} / {ey:.2e} <= {tol:g}",
              flush=True)
        check(ex <= tol and ey <= tol, f"qr 35: least squares {dt} off torch.linalg.lstsq")
    del G, b, Qg, Rg
    c_tall = dict(hk.LAUNCHES)
    counts["gemm"] += c_tall["gemm"]
    counts["gemm_tma"] += c_tall["gemm_tma"]
    torch.cuda.empty_cache()

    # the native host scatter/gather of the N=32768 f32 matrix
    H = randn(N, N, seed=40).cpu().numpy()
    native.load()  # the build (at first use) is not timed
    t0 = time.perf_counter()
    S_fast = geom.scatter(H)
    t_sc = time.perf_counter() - t0
    t0 = time.perf_counter()
    G_fast = geom.gather(S_fast)
    t_ga = time.perf_counter() - t0
    check(native.scatter(H[:8, :8], 8, 1, 1) is not None, "qr 35: the native path did not run")
    fast_s, fast_g = native.scatter, native.gather
    native.scatter = native.gather = lambda *a: None
    try:
        t0 = time.perf_counter()
        S_slow = geom.scatter(H)
        t_sc2 = time.perf_counter() - t0
        t0 = time.perf_counter()
        G_slow = geom.gather(S_slow)
        t_ga2 = time.perf_counter() - t0
    finally:
        native.scatter, native.gather = fast_s, fast_g
    same = np.array_equal(S_fast, S_slow) and np.array_equal(G_fast, G_slow) \
        and np.array_equal(G_fast, H)
    print(f"[qr 35]   LUGeometry.scatter/gather of (32768, 32768) f32 on the host: native "
          f"{t_sc * 1e3:.1f} / {t_ga * 1e3:.1f} ms ({native.nthreads()} OpenMP threads; build "
          f"{native.build_seconds} s), numpy "
          f"{t_sc2 * 1e3:.1f} / {t_ga2 * 1e3:.1f} ms; bitwise {same}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(same, "qr 35: native scatter/gather differ from the numpy path")
    return counts


def phase_dist_qr_ranks() -> dict:
    """(36) Several ranks on the one card over "staged", as phase 34: a
    test of correctness, not of scaling. `tsqr_distributed` at Px = 4
    (gather, butterfly) and Px = 3 (butterfly) on (262144, 256): R bitwise
    on every rank and within the bar, butterfly allclose gather;
    `qr_factor_distributed` at 2x2x1 and 2x1x2, N=8192, v=256 (K1 counted
    against `gemm_launches`), the QR miniapp's --full --p_grid 2,2,1 route,
    all within residual_bound(N, f32); at N=2048, v=128, 2x2x1, R allclose
    the same code's on the CPU's threaded world. Returns the launches."""
    import numpy as np

    from conflux_tpu_torch.cli.qr_miniapp import _tall_residuals
    from conflux_tpu_torch.geometry import Grid3, LUGeometry
    from conflux_tpu_torch.ops import hopper_kernels as hk
    from conflux_tpu_torch.parallel.mesh import gather_shards, run_threaded
    from conflux_tpu_torch.qr.distributed import (
        gemm_launches,
        qr_factor_distributed,
        r_geometry,
        tsqr_distributed,
    )
    from conflux_tpu_torch.validation import qr_residual_distributed, residual_bound

    t_phase = time.perf_counter()
    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    # tall-skinny over x
    M, n = 262144, 256
    gen = torch.Generator(device="cuda").manual_seed(41)
    T = torch.randn((M, n), generator=gen, device="cuda").cpu()
    bar_t = residual_bound(n, torch.float32)
    Rs = {}
    for Px, tree in ((4, "gather"), (4, "butterfly"), (3, "butterfly")):
        Ml = -(-M // Px)
        Tp = torch.zeros((Px * Ml, n))
        Tp[:M] = T

        def fn(mesh):
            a = Tp[mesh.x * Ml:(mesh.x + 1) * Ml].to(mesh.device)
            mesh.barrier()
            t0 = time.perf_counter()
            Q, R = tsqr_distributed(a, mesh, tree=tree)
            torch.cuda.synchronize()
            mesh.barrier()
            dt = (time.perf_counter() - t0) * 1e3
            return R.cpu(), _tall_residuals(a, Q, R, mesh), dt, dict(mesh.stats)

        res = run_threaded(Grid3(Px, 1, 1), fn, device="cuda", transport="staged",
                           timeout=900.0)
        same = all(torch.equal(r[0], res[0][0]) for r in res)
        rec, orth = res[0][1]
        Rs[(Px, tree)] = res[0][0]
        print(f"[ranks 36] tsqr_distributed ({M}, {n}) Px={Px} {tree}: {res[0][2]:.1f} ms (a "
              f"correctness test: the ranks share one card and one host; {CARD}), R bitwise on "
              f"every rank {same}, reconstruction {rec:.3e}, orth {orth:.3e} <= {bar_t:.3e}; "
              f"staged {sum(r[3]['staged_bytes'] for r in res)} bytes", flush=True)
        check(same and rec <= bar_t and orth <= bar_t, f"ranks 36: tsqr Px={Px} {tree}")
    diff = _rel_max(Rs[(4, "butterfly")], Rs[(4, "gather")])
    print(f"[ranks 36]   Px=4 butterfly against gather: max rel {diff:.2e} <= {bar_t:.3e}",
          flush=True)
    check(diff <= bar_t, "ranks 36: butterfly and gather disagree")

    def qr_world(gridspec, N, v, device, transport):
        grid = Grid3(*gridspec)
        geom = LUGeometry.create(N, N, v, grid)
        g = torch.Generator(device="cpu").manual_seed(N)
        A = torch.randn((N, N), generator=g)

        def fn(mesh):
            shard = geom.local_block(A, mesh.x, mesh.y).to(mesh.device).contiguous()
            mesh.barrier()
            t0 = time.perf_counter()
            Q, R = qr_factor_distributed(shard, geom, mesh)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize()
            mesh.barrier()
            dt = (time.perf_counter() - t0) * 1e3
            res = qr_residual_distributed(shard, Q, R, geom, mesh)
            return gather_shards(R, mesh).cpu(), res, dt, dict(mesh.stats)

        out = run_threaded(grid, fn, device=device, transport=transport, timeout=900.0)
        same = all(torch.equal(r[0], out[0][0]) for r in out)
        R = np.triu(r_geometry(geom).gather(out[0][0].numpy())[:N, :N])
        return out, same, R, geom

    bar = residual_bound(8192, torch.float32)
    for gridspec in ((2, 2, 1), (2, 1, 2)):
        hk.reset_launches()
        out, same, _R, geom = qr_world(gridspec, 8192, 256, "cuda", "staged")
        c = dict(hk.LAUNCHES)
        add(c)
        rec, orth = out[0][1]
        want = gemm_launches(geom)
        print(f"[ranks 36] qr_factor_distributed {Grid3(*gridspec)} N=8192 v=256: "
              f"{max(r[2] for r in out):.1f} ms (a correctness test; {CARD}), reconstruction "
              f"{rec:.3e}, orth {orth:.3e} <= {bar:.3e}, R identical on every rank {same}; K1 "
              f"{c['gemm']} launches, predicted {want}; staged "
              f"{sum(r[3]['staged_bytes'] for r in out)} bytes over "
              f"{sum(r[3]['collectives'] for r in out)} collectives", flush=True)
        check(same and rec <= bar and orth <= bar and c["gemm"] == want,
              f"ranks 36: qr {gridspec} failed")
    lines, c_app = run_miniapp(["--full", "-M", "8192", "--cols", "8192", "-b", "256",
                                "--p_grid", "2,2,1", "-r", "1", "--validate"],
                               app="qr_miniapp", kernels=("gemm",))
    add(c_app)
    check(_field(lines, "_grid_").startswith("_grid_ 2x2x1 ranks=4 world=threads "
                                             "transport=staged"), "ranks 36: miniapp world")
    resl = _field(lines, "_residual_")
    orth_a = float(resl.split("orth=")[1].split()[0])
    rec_a = float(resl.split("reconstruction=")[1])
    check(orth_a <= bar and rec_a <= bar, f"ranks 36: miniapp residuals {resl}")
    hk.reset_launches()
    card, same_c, Rc, _g = qr_world((2, 2, 1), 2048, 128, "cuda", "staged")
    add(dict(hk.LAUNCHES))
    cpu, _same, Rh, _g = qr_world((2, 2, 1), 2048, 128, "cpu", "gloo")
    bar2 = residual_bound(2048, torch.float32)
    d = float(np.abs(Rc - Rh).max() / np.abs(Rh).max())
    print(f"[ranks 36] 2x2x1 N=2048 v=128: R on the card against the CPU threaded world's "
          f"max rel {d:.2e} <= {bar2:.3e}; phase {time.perf_counter() - t_phase:.1f} s, "
          f"launches {total}", flush=True)
    check(same_c and d <= bar2, "ranks 36: the card's R differs from the CPU world's")
    torch.cuda.empty_cache()
    return total


# --------------------------------------------------------------------------- #
# 37-38: the serving mesh lane and several lanes, on the one card
# --------------------------------------------------------------------------- #


def _bitwise(xs, ys) -> int:
    return sum(int(x.shape == y.shape and bool((x == y).all())) for x, y in zip(xs, ys))


def phase_mesh() -> dict:
    """(37) The mesh lane on one card: `batch_mesh(["cuda:0", "cuda:0"])`,
    two shards of one card (a correctness path, not a scaling result).
    (a) BENCH_MESH.json's shape: a (32, 256, 256) f32 plan, v=128; the
    bare `plan.factor` launches K4 once per shard (held against its plain
    version at the shard's (16, 256, 256)), its factors and solves are
    compared with the one-device plan's; an engine after prewarm serves
    128 requests of widths 1,1,2,4, every answer bitwise the bare loop's
    (12 alone first), K3 twice a batch (each first round at each shape
    held), max |A x - b| < SOLVE_TOL, no build and no program after
    prewarm, `mesh_plan_unsupported` 0; solves/s beside the bare loop's
    and the one-device plan's engine; an SPD mesh plan's factor through
    K5 (held) beside the one-device plan's. (b) The large-N mesh session
    at full width, (2, 4096, 4096) f32 over the two shards: a checked
    engine factor (`_mesh_factor_health_fn`, K4 once per shard, held),
    solves bitwise the bare session's, spill and revive through a
    ResidentSet (host, then disk) bitwise, checkpoint()/restore()
    bitwise, K4's time per shard beside `torch.linalg.lu_factor` of
    (1, 4096, 4096), a poisoned RHS refused at admission and a deadline
    that evicts a mesh request mid-window. Returns the launches."""
    from conflux_tpu_torch import profiler, resilience, serve
    from conflux_tpu_torch.batched import batch_mesh, gather_batch
    from conflux_tpu_torch.engine import ServeEngine
    from conflux_tpu_torch.ops import hopper_kernels as hk
    from conflux_tpu_torch.resilience import DeadlineExceeded, HealthPolicy, RhsNonFinite
    from conflux_tpu_torch.tier import ResidentSet

    t_phase = time.perf_counter()
    total: dict = {}
    unsup0 = resilience.health_stats().get("mesh_plan_unsupported", 0)
    mesh = batch_mesh(["cuda:0", "cuda:0"])
    B, n, R = 32, 256, 128
    serve.clear_plans()
    mplan = serve.FactorPlan.create((B, n, n), torch.float32, v=128, mesh=mesh)
    oplan = serve.FactorPlan.create((B, n, n), torch.float32, v=128)
    A = _systems(B, n, 370)
    torch.cuda.synchronize()
    hk.reset_launches()
    with _held_to_plain("mesh 37", ("batched_lu",)):
        bare = mplan.factor(A)
        torch.cuda.synchronize()
    c = dict(hk.LAUNCHES)
    _add_counts(total, c)
    one = oplan.factor(A)
    fac_same = all(torch.equal(gather_batch(f), g) for f, g in zip(bare.factors, one.factors))
    trace = _engine_trace([bare], R, ENGINE_WIDTHS, 37)
    direct = _direct(trace)
    one_x = _direct([(one, b) for _s, b in trace])
    one_same = _bitwise(direct, one_x)
    print(f"[mesh 37] (a) {mesh} over ({B}, {n}, {n}) f32 (two shards of one card: a "
          f"correctness path, not a scaling result; {CARD}): bare plan.factor launched K4 "
          f"{c['batched_lu']} times; factors bitwise the one-device plan's {fac_same}, the "
          f"bare loop's {R} answers bitwise the one-device plan's {one_same}/{R}", flush=True)
    check(c["batched_lu"] == 2 and c["btrsm"] == 0, f"mesh 37: bare factor launches {c}")
    check(fac_same and one_same == R, "mesh 37: the mesh plan differs from the one-device plan")
    with ServeEngine(max_batch_delay=0.002, max_coalesce_width=32) as eng:
        eng.prewarm(mplan, factor_batches=(1,))
        hk.reset_launches()
        es = eng.factor(mplan, A.cpu().numpy(), timeout=600)
        torch.cuda.synchronize()
        cf = dict(hk.LAUNCHES)
        _add_counts(total, cf)
        es_same = all(all(torch.equal(x, y) for x, y in zip(f.shards, g.shards))
                      for f, g in zip(es.factors, bare.factors))
        eng.prewarm(es, widths=(1, 2, 4, 8, 16, 32))
        builds0, made0 = profiler.compile_count(), _programs(mplan)
        etrace = [(es, b) for _s, b in trace]
        torch.cuda.synchronize()
        hk.reset_launches()
        with _held_to_plain("mesh 37", ("btrsm",)):
            solo = [eng.submit(s, b).result(600) for s, b in etrace[:12]]
            xs, _sec = _engine_leg(eng, etrace)
            torch.cuda.synchronize()
        counts = dict(hk.LAUNCHES)
        _add_counts(total, counts)
        st = eng.stats()
        builds = profiler.compile_count() - builds0
        made = _programs(mplan) - made0
        bitwise = _bitwise(xs, direct)
        solo_ok = _bitwise(solo, direct[:12]) == 12
        worst = _max_resid([(one, b) for _s, b in trace], xs)
        batches = st["batches"]
    print(f"[mesh 37] (a) engine: factor launched K4 {cf['batched_lu']} times (one sharded "
          f"dispatch, factor bucket hits {st['factor_bucket_hits']}), session bitwise the bare "
          f"factor {es_same}; 12 requests alone, then {R}: {batches} batches (coalesced mean "
          f"{st['coalesced_mean']:.2f}), launches {counts}; bitwise the bare loop {bitwise}/{R}; "
          f"max |A x - b| {worst:.3e} (bar {SOLVE_TOL:g}); after prewarm {builds} kernel "
          f"builds, {made} programs made", flush=True)
    check(cf["batched_lu"] == 2 and st["factor_bucket_hits"] == {1: 1} and es_same,
          f"mesh 37: engine factor {cf}, {st['factor_bucket_hits']}, bitwise {es_same}")
    check(bitwise == R and solo_ok, f"mesh 37: engine answers bitwise {bitwise}/{R}")
    check(worst < SOLVE_TOL, f"mesh 37: max |A x - b| {worst:.3e}")
    check(builds == 0 and made == 0, f"mesh 37: {builds} builds, {made} programs after prewarm")
    check(counts["btrsm"] == 2 * batches and counts["batched_lu"] == 0,
          f"mesh 37: K3 {counts['btrsm']} != 2 x {batches} batches: {counts}")
    # solves/s: the mesh lane, the bare loop, the one-device plan's engine
    rates = {}
    with ServeEngine(max_batch_delay=0.002, max_coalesce_width=32) as eng:
        eng.prewarm(es, widths=(1, 2, 4, 8, 16, 32))
        eng.prewarm(one, widths=(1, 2, 4, 8, 16, 32))
        otrace = [(one, b) for _s, b in trace]
        legs = {"mesh": [], "one": [], "bare": []}
        for _ in range(5):
            legs["mesh"].append(_engine_leg(eng, etrace)[1])
            legs["one"].append(_engine_leg(eng, otrace)[1])
            legs["bare"].append(_sequential_leg(trace))
        rates = {k: R / _median(v) for k, v in legs.items()}
    print(f"[mesh 37] (a) {rates['mesh']:.1f} solves/s through the mesh lane, "
          f"{rates['one']:.1f} through the engine on the one-device plan "
          f"({rates['mesh'] / rates['one']:.2f}x), {rates['bare']:.1f} the bare mesh loop "
          f"(session.solve + copy to the host); median of 5 interleaved legs, host clock, "
          f"{CARD}", flush=True)
    # an SPD mesh plan: K5 once per shard, held, against the one-device plan
    S = _spd_systems(B, n, 371)
    splan = serve.FactorPlan.create((B, n, n), torch.float32, v=128, kind="chol", mesh=mesh)
    sone = serve.FactorPlan.create((B, n, n), torch.float32, v=128, kind="chol")
    torch.cuda.synchronize()
    hk.reset_launches()
    with _held_to_plain("mesh 37 spd", ("batched_chol", "btrsm")):
        ss = splan.factor(S)
        xsp = ss.solve(trace[0][1])
        torch.cuda.synchronize()
    c5 = dict(hk.LAUNCHES)
    _add_counts(total, c5)
    so = sone.factor(S)
    spd_same = (all(torch.equal(gather_batch(f), g) for f, g in zip(ss.factors, so.factors))
                and torch.equal(xsp, so.solve(trace[0][1])))
    print(f"[mesh 37] (a) SPD mesh plan: launches {c5}; factors and a solve bitwise the "
          f"one-device plan's {spd_same}", flush=True)
    check(c5["batched_chol"] == 2 and c5["btrsm"] == 2 and spd_same,
          f"mesh 37: SPD mesh plan {c5}, bitwise {spd_same}")
    del bare, one, es, ss, so, S, A
    torch.cuda.empty_cache()

    # (b) the large-N mesh session at full width
    N = 4096
    eplan = serve.FactorPlan.create((2, N, N), torch.float32, v=128, mesh=mesh)
    Ae = _systems(2, N, 372)
    Ah = Ae.cpu().numpy()
    gen = torch.Generator().manual_seed(373)
    bes = [torch.randn((2, N, w), generator=gen).numpy() for w in (1, 2, 1, 4)]
    with ServeEngine(max_batch_delay=0.002, health=HealthPolicy()) as eng:
        eng.prewarm(eplan, factor_batches=(1,))
        torch.cuda.synchronize()
        hk.reset_launches()
        with _held_to_plain("mesh 37 large-N", ("batched_lu", "btrsm")):
            es = eng.factor(eplan, Ah, timeout=900)
            torch.cuda.synchronize()
            ce = dict(hk.LAUNCHES)
            oracle = eplan.factor(Ae)
            xo = [oracle.solve(b).cpu().numpy() for b in bes]
            eng.prewarm(es, widths=(1, 2, 4))
            xe = [eng.solve(es, b, timeout=600) for b in bes]
            torch.cuda.synchronize()
        _add_counts(total, dict(hk.LAUNCHES))
        same_f = all(all(torch.equal(x, y) for x, y in zip(f.shards, g.shards))
                     for f, g in zip(es.factors, oracle.factors))
        same_x = _bitwise(xe, xo)
        res = max(float((Ae.double() @ torch.from_numpy(x).cuda().double()
                         - torch.from_numpy(b).cuda().double()).abs().max())
                  for x, b in zip(xe, bes))
        rs = ResidentSet(disk_dir=tempfile.mkdtemp(prefix="mesh37-"))
        rs.adopt(es)
        rs.spill(es)
        host_tier = es.tier
        x_host = eng.solve(es, bes[1], timeout=600)
        rs.spill(es)
        rs.demote(es)
        disk_tier = es.tier
        x_disk = eng.solve(es, bes[1], timeout=600)
        tiered = (host_tier == "host" and disk_tier == "disk"
                  and bool((x_host == xo[1]).all()) and bool((x_disk == xo[1]).all()))
        with tempfile.TemporaryDirectory(prefix="mesh37ck-") as d:
            eng.checkpoint(d, sessions=[es], names=["m"])
            serve.clear_plans()
            with ServeEngine(max_batch_delay=0.002) as eng2:
                (back,) = eng2.restore(d)
                x_back = eng2.solve(back, bes[3], timeout=600)
        restored = bool((x_back == xo[3]).all())
        # a poisoned rhs is refused at admission (the submit guard reads the
        # first elements); one poisoned past them fails alone at staging
        bad = bes[0].copy()
        bad[0, 17, 0] = float("nan")
        try:
            eng.submit(es, bad)
            refused = False
        except RhsNonFinite:
            refused = True
        late = bes[0].copy()
        late[1, 17, 0] = float("nan")
        f_bad, f_good = eng.submit(es, late), eng.submit(es, bes[1])
        try:
            f_bad.result(600)
        except RhsNonFinite:
            refused = refused and bool((f_good.result(600) == xo[1]).all())
        else:
            refused = False
    print(f"[mesh 37] (b) ({2}, {N}, {N}) f32 over two shards ({CARD}): checked engine factor "
          f"launched K4 {ce['batched_lu']} times ({_geometry('batched_lu', Ae[:1])} per shard), "
          f"factors bitwise the bare plan.factor's {same_f}; 4 solves (widths 1,2,1,4) bitwise "
          f"the bare session's {same_x}/4, max |A x - b| {res:.3e}; spill to host and disk and "
          f"revive bitwise {tiered}; checkpoint()/restore() bitwise {restored}; NaN rhs refused "
          f"at admission, and one past the submit guard's sample failed alone at staging "
          f"{refused}", flush=True)
    check(ce["batched_lu"] == 2 and same_f and same_x == 4 and tiered and restored and refused,
          "mesh 37: the large-N mesh session failed a check")
    check(res < 1e-3, f"mesh 37: large-N max |A x - b| {res:.3e}")
    # a deadline evicts a mesh request mid-window
    h0 = resilience.health_stats().get("evictions", 0)
    eng = ServeEngine(max_batch_delay=60.0)
    try:
        t0 = time.perf_counter()
        fut = eng.submit(oracle, bes[0], deadline=0.1)
        try:
            fut.result(60)
            evicted = False
        except DeadlineExceeded:
            evicted = time.perf_counter() - t0 < 30
    finally:
        eng.close(timeout=600)
    evictions = resilience.health_stats().get("evictions", 0) - h0
    check(evicted and evictions == 1, f"mesh 37: deadline eviction {evicted}, {evictions}")
    # K4's instance at (1, 4096, 4096), one shard, beside the library LU
    A1 = Ae[:1].contiguous()
    k4_ms = time_ms(lambda: hk.batched_lu(A1), 3)
    lib_ms = time_ms(lambda: torch.linalg.lu_factor(A1), 3)
    r = _lu_bound(1, N, 4)
    unsup = resilience.health_stats().get("mesh_plan_unsupported", 0) - unsup0
    print(f"[mesh 37] (b) K4 per shard at (1, {N}, {N}) f32 ({_geometry('batched_lu', A1)}): "
          f"{k4_ms:.3f} ms, torch.linalg.lu_factor {lib_ms:.3f} ms, bound "
          f"{r['bound_ms']:.3f} ms ({r['bound_by']}); deadline evicted mid-window {evicted}; "
          f"mesh_plan_unsupported {unsup}; phase {time.perf_counter() - t_phase:.1f} s, launches "
          f"{total} ({CARD})", flush=True)
    check(unsup == 0, f"mesh 37: mesh_plan_unsupported {unsup}")
    del es, oracle, back, Ae, A1
    torch.cuda.empty_cache()
    return total


def phase_lanes() -> dict:
    """(38) Two lanes on one card, `ServeEngine(devices=["cuda:0",
    "cuda:0"])` (two streams; a correctness path, not a scaling result),
    on BENCH_FLEET.json's trace: a (32, 256, 256) f32 plan, v=128, 128
    requests of widths 1,1,2,4 over 4 sessions (two pinned to each lane
    by sid), then a churn of 32 pooled cold starts, max_factor_batch 8.
    Every answer bitwise the one-lane engine's, every pooled session
    bitwise `plan.factor`'s; per-lane telemetry (both lanes serve); K3
    once per batch and K4 once per factor batch, the first call at each
    shape held against the plain versions; no build and no program after
    prewarm. An injected kill on lane 0's dispatcher fails only that
    lane's request; the lane revives and serves bitwise. Solves/s and
    sessions/s for two lanes and for one (host clock). Returns the
    launches."""
    import numpy as np

    from conflux_tpu_torch import profiler, serve
    from conflux_tpu_torch.engine import EngineClosed, ServeEngine, rendezvous
    from conflux_tpu_torch.ops import hopper_kernels as hk
    from conflux_tpu_torch.resilience import FaultPlan, FaultSpec

    t_phase = time.perf_counter()
    total: dict = {}
    B, n, R, S, churn = 32, 256, 128, 4, 32
    serve.clear_plans()
    plan = serve.FactorPlan.create((B, n, n), torch.float32, v=128)
    rng = np.random.default_rng(38)
    A = (rng.standard_normal((S, B, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)).astype(np.float32)
    Ach = (rng.standard_normal((churn, B, n, n)) / np.sqrt(n)
           + 2.0 * np.eye(n)).astype(np.float32)
    widths = ENGINE_WIDTHS
    reqs = [(i % S, rng.standard_normal((B, n, widths[i % 4])).astype(np.float32))
            for i in range(R)]
    two = ["cuda:0", "cuda:0"]
    # sids that pin two sessions to each lane of the two-lane engine
    keys = ServeEngine._lane_keys([torch.device("cuda", 0)] * 2)
    sids, i = [], 0
    while len(sids) < S:
        sid = f"fleet-{i}"
        i += 1
        if rendezvous(sid, keys) == keys[len(sids) % 2]:
            sids.append(sid)
    sessions = [plan.factor(A[s], sid=sids[s]) for s in range(S)]

    def make(devices):
        return ServeEngine(max_batch_delay=0.002, max_pending=4 * (R + churn),
                           max_coalesce_width=32, max_factor_batch=8, devices=devices)

    out = {}
    for devices in (["cuda:0"], two):
        eng = make(devices)
        try:
            eng.prewarm(sessions[0], widths=(1, 2, 4, 8, 16, 32),
                        factor_batches=(1, 2, 4, 8))
            builds0, made0 = profiler.compile_count(), _programs(plan)
            torch.cuda.synchronize()
            hk.reset_launches()
            with _held_to_plain(f"lanes 38 ({len(devices)})", ("btrsm", "batched_lu")):
                futs = [eng.submit(sessions[s], b) for s, b in reqs]
                xs = [f.result(600) for f in futs]
                cfut = [eng.submit_factor(plan, Ach[i]) for i in range(churn)]
                opened = [f.result(600) for f in cfut]
                torch.cuda.synchronize()
            counts = dict(hk.LAUNCHES)
            _add_counts(total, counts)
            st = eng.stats()
            builds = profiler.compile_count() - builds0
            made = _programs(plan) - made0
            out[len(devices)] = (xs, opened, counts, st, builds, made)
        finally:
            eng.close(timeout=600)
    xs1, op1, _c1, _st1, _b1, _m1 = out[1]
    xs2, op2, c2, st2, b2, m2 = out[2]
    same = _bitwise(xs2, xs1)
    refs = [plan.factor(Ach[i]) for i in range(churn)]
    pooled = sum(int(all(torch.equal(a, b) for a, b in zip(s.factors, r.factors)))
                 for s, r in zip(op2, refs))
    rows = st2["lanes"]
    lane_pins = sorted({s._lane_key for s in sessions})
    print(f"[lanes 38] two lanes on {two} ({CARD}; a correctness path, not a scaling "
          f"result): {R} requests over {S} sessions (pins {lane_pins}) bitwise the one-lane "
          f"engine's {same}/{R}; {churn} pooled cold starts all resolved, bitwise plan.factor's "
          f"{pooled}/{churn}; per lane batches {[r['batches'] for r in rows]}, factor batches "
          f"{[r['factor_batches'] for r in rows]}, occupancy "
          f"{[round(r['occupancy'], 3) for r in rows]}; launches {c2} (batches "
          f"{st2['batches']}, factor batches {st2['factor_batches']}); after prewarm {b2} "
          f"builds, {m2} programs", flush=True)
    check(same == R and pooled == churn, f"lanes 38: bitwise {same}/{R}, pooled {pooled}")
    check(all(r["batches"] >= 1 for r in rows) and len(lane_pins) == 2,
          f"lanes 38: a lane never served: {rows}")
    check(c2["btrsm"] == st2["batches"] and c2["batched_lu"] == st2["factor_batches"],
          f"lanes 38: launches {c2} against batches {st2['batches']}, "
          f"{st2['factor_batches']}")
    check(b2 == 0 and m2 == 0, f"lanes 38: {b2} builds, {m2} programs after prewarm")
    # an injected kill on lane 0's dispatcher: its request fails alone
    faults = FaultPlan([FaultSpec("dispatch", "kill", count=1)])
    eng = ServeEngine(max_batch_delay=0.0, devices=two, watchdog_interval=0.05,
                      fault_plan=faults)
    try:
        s0 = next(s for s in sessions if eng._lane_for(s).index == 0)
        s1 = next(s for s in sessions if eng._lane_for(s).index == 1)
        b = reqs[0][1]
        want0, want1 = s0.solve(b).cpu().numpy(), s1.solve(b).cpu().numpy()
        try:
            eng.submit(s0, b).result(60)
            killed = False
        except EngineClosed:
            killed = True
        other = bool((eng.solve(s1, b, timeout=600) == want1).all())
        t0 = time.time()
        while time.time() - t0 < 30 and not (eng.lanes[0].revives >= 1
                                              and eng.lanes[0]._dispatcher.is_alive()):
            time.sleep(0.02)
        revived = bool((eng.solve(s0, b, timeout=600) == want0).all())
        revives = eng.lanes[0].revives
    finally:
        eng.close(timeout=600)
    print(f"[lanes 38] kill on lane 0's dispatcher: its request failed {killed}, lane 1 "
          f"served bitwise {other}, lane 0 revived ({revives}) and served bitwise {revived}",
          flush=True)
    check(killed and other and revived and revives >= 1, "lanes 38: the lane fault domain")
    # solves/s and sessions/s, two lanes and one, interleaved legs
    rates = {1: ([], []), 2: ([], [])}
    engs = {1: make(["cuda:0"]), 2: make(two)}
    try:
        for k, e in engs.items():
            e.prewarm(sessions[0], widths=(1, 2, 4, 8, 16, 32), factor_batches=(1, 2, 4, 8))
        for _ in range(3):
            for k, e in engs.items():
                t0 = time.perf_counter()
                for f in [e.submit(sessions[s], b) for s, b in reqs]:
                    f.result(600)
                rates[k][0].append(B * sum(b.shape[-1] for _s, b in reqs)
                                   / (time.perf_counter() - t0))
                t0 = time.perf_counter()
                for f in [e.submit_factor(plan, Ach[i]) for i in range(churn)]:
                    f.result(600)
                rates[k][1].append(churn / (time.perf_counter() - t0))
    finally:
        for e in engs.values():
            e.close(timeout=600)
    s1_, f1_ = _median(rates[1][0]), _median(rates[1][1])
    s2_, f2_ = _median(rates[2][0]), _median(rates[2][1])
    print(f"[lanes 38] two lanes {s2_:.1f} solves/s, {f2_:.2f} sessions/s; one lane "
          f"{s1_:.1f} solves/s, {f1_:.2f} sessions/s ({s2_ / s1_:.2f}x, {f2_ / f1_:.2f}x; "
          f"solves = systems x columns; median of 3 interleaved legs, host clock, {CARD}); "
          f"phase {time.perf_counter() - t_phase:.1f} s, launches {total}", flush=True)
    del sessions, refs, op2, out
    torch.cuda.empty_cache()
    return total


# --------------------------------------------------------------------------- #
# 39-40: the per-phase device tables of the grid routes, and lockcheck soaks
# --------------------------------------------------------------------------- #

# the named-scope phases of the JAX package's grid programs
# (tests/test_torch_profiler_trace.py holds the port's names to them)
LU_PHASES = {"step0_reduce", "step1_pivoting", "step2_pivotrows", "step4_dtrsm",
             "step5_dtrsm", "step6_dgemm", "step7_writes"}
CHOL_PHASES = {"reduceA11", "choleskyA00", "updateA10", "scatterA11", "computeA11"}
QR_PHASES = {"qr_panel_reduce", "qr_reproject", "qr_panel_tsqr", "qr_trailing_c",
             "qr_trailing_update", "qr_writes"}


def _traced_table(tag: str, prog, shard, mesh, phases: set, phase_re: str,
                  k1_phase: str, k2_phase: str | None) -> tuple[dict, dict]:
    """One untraced run of `prog` and one traced by `profiler.trace`; prints
    the traced run's phase table and checks it: every phase of `phases`
    present, every device event counted once, every K1 launch under
    `k1_phase` (and K2 under `k2_phase`) and as many as the launch counts
    say, the traced output bitwise the untraced. Returns (table, the
    traced run's launches)."""
    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.ops import hopper_kernels as hk

    want = prog(shard, mesh)
    torch.cuda.synchronize()
    hk.reset_launches()
    with tempfile.TemporaryDirectory(prefix="phases39-") as d:
        t0 = time.perf_counter()
        with profiler.trace(d):
            got = prog(shard, mesh)
        traced_s = time.perf_counter() - t0
        counts = dict(hk.LAUNCHES)
        print(f"[phases 39] {tag} ({CARD}): traced run {traced_s:.2f} s (trace included), "
              f"launches {counts}", flush=True)
        table = profiler.phase_table(d, phase_re=phase_re)
        durs = profiler._trace_durations(d)
        launched = profiler.launch_phases(d, phase_re)
    same = all(torch.equal(a, b) for a, b in zip(want, got))
    events = sum(n for _name, _ms, n in durs.values())
    counted = sum(n for _ms, n in table.values())
    ms_all = sum(ms for _name, ms, _n in durs.values())
    ms_table = sum(ms for ms, _n in table.values())
    k1 = [p for p, name, _ms, _n in launched.values()
          if "gemm_tma_kernel" in name or "gemm_simt_kernel" in name]
    k2 = [p for p, name, _ms, _n in launched.values() if "lu_block_kernel" in name]
    missing = phases - set(table)
    print(f"[phases 39] {tag}: device events {events}, counted {counted} ({ms_table:.3f} of "
          f"{ms_all:.3f} ms); K1 {len(k1)} launches under {sorted(set(k1))} (counts "
          f"{counts['gemm']}), K2 {len(k2)} under {sorted(set(k2))} (counts "
          f"{counts['lu_block']}); phases missing {sorted(missing)}; traced output bitwise "
          f"the untraced {same}", flush=True)
    check(not missing, f"phases 39 {tag}: phases missing {sorted(missing)}")
    check(counted == events and abs(ms_table - ms_all) <= 1e-6 * max(1.0, ms_all),
          f"phases 39 {tag}: {counted} events counted of {events}")
    check(len(k1) == counts["gemm"] > 0 and set(k1) == {k1_phase},
          f"phases 39 {tag}: K1 {len(k1)} under {set(k1)}, counts {counts['gemm']}")
    if k2_phase is None:
        check(not k2 and counts["lu_block"] == 0, f"phases 39 {tag}: K2 launched")
    else:
        check(len(k2) == counts["lu_block"] > 0 and set(k2) == {k2_phase},
              f"phases 39 {tag}: K2 {len(k2)} under {set(k2)}, counts {counts['lu_block']}")
    check(same, f"phases 39 {tag}: the traced output is not bitwise the untraced one")
    del want, got
    torch.cuda.empty_cache()
    return table, counts


def phase_phase_tables() -> dict:
    """(39) The per-phase device tables of the grid routes, as the
    miniapps' --profile prints them (`profiler.trace`, `phase_table`): the
    LU grid program at N=32768, v=1024, f32, 1x1x1 (bench.py's
    configuration, full size), CONFCHOX at N=32768, v=1024, and the grid
    QR at N=16384, v=1024: a depth cut, since one untraced QR run takes
    ~8 s at N=32768 and the phase runs each program twice (untraced, then
    traced). The timed runs of phases 32-35 stay untraced. Each table is
    printed and held: every phase of the JAX package's program present,
    every device event of the traced run counted once, each K1 launch
    under step6_dgemm / computeA11 / qr_trailing_update and each K2 launch
    under step1_pivoting, as many as the launch counts, and the traced
    output bitwise the untraced run's. Returns the traced runs' launches."""
    import numpy as np

    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.cholesky.distributed import build_program as chol_program
    from conflux_tpu_torch.geometry import CholeskyGeometry, Grid3, LUGeometry
    from conflux_tpu_torch.io import generate_spd_local
    from conflux_tpu_torch.lu.distributed import build_program as lu_program
    from conflux_tpu_torch.parallel.mesh import distribute_shards, make_mesh
    from conflux_tpu_torch.qr.distributed import build_program as qr_program

    t_phase = time.perf_counter()
    grid = Grid3(1, 1, 1)
    mesh = make_mesh(grid)
    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    gen = torch.Generator(device="cuda").manual_seed(0)
    N, v = 32768, 1024
    A = torch.randn((N, N), generator=gen, device="cuda")
    A.diagonal().add_(2.0)
    geom = LUGeometry.create(N, N, v, grid)
    _t, c = _traced_table("LU N=32768 v=1024 f32 1x1x1", lu_program(geom, mesh, dtype=A.dtype),
                          A, mesh, LU_PHASES, profiler._PHASE_RE, "step6_dgemm",
                          "step1_pivoting")
    add(c)
    del A
    cgeom = CholeskyGeometry.create(N, v, grid)
    shard = distribute_shards(lambda px, py: generate_spd_local(cgeom, px, py, dtype=np.float32),
                              mesh, shape=(1, 1, cgeom.Ml, cgeom.Nl), dtype=np.float32)
    _t, c = _traced_table("CONFCHOX N=32768 v=1024 f32 1x1x1",
                          lambda s, m: (chol_program(cgeom, mesh, dtype=s.dtype)(s, m),),
                          shard, mesh, CHOL_PHASES, profiler._PHASE_RE, "computeA11", None)
    add(c)
    del shard
    Nq = 16384
    Q = torch.randn((Nq, Nq), generator=gen, device="cuda")
    qgeom = LUGeometry.create(Nq, Nq, v, grid)
    _t, c = _traced_table("QR N=16384 v=1024 f32 1x1x1 (depth cut)",
                          qr_program(qgeom, mesh, dtype=Q.dtype), Q, mesh, QR_PHASES,
                          profiler.QR_PHASE_RE, "qr_trailing_update", None)
    add(c)
    del Q
    torch.cuda.empty_cache()
    print(f"[phases 39] phase {time.perf_counter() - t_phase:.1f} s, launches {total} "
          f"({CARD})", flush=True)
    return total


def phase_lockcheck_soaks() -> dict:
    """(40) `scripts/torch_soak.py --serve --lockcheck`, then `--tier
    --lockcheck`, on the card, in this process, each for a time budget of
    30 s: engines with the full HealthPolicy under the serve fault menu,
    then a ResidentSet-managed engine under the tier fault sites, every
    lock the port creates watched by `analysis.lockcheck`. Each must end
    with 0 failed trials (a wrong answer fails its trial), 0 lock-order
    cycles and 0 engine locks held across a serve.* dispatch region, and
    launch K3 and K4. Returns the launches."""
    from conflux_tpu_torch.ops import hopper_kernels as hk

    mod = _script_module("scripts/torch_soak.py")
    mod.ENGINE["device"] = "cuda"
    total: dict = {}
    for mode in ("serve", "tier"):
        torch.cuda.synchronize()
        hk.reset_launches()
        out = mod.soak(mode, trials=1000, seed=0, time_budget=30.0, lockcheck=True,
                       emit=lambda m: None)
        torch.cuda.synchronize()
        counts = dict(hk.LAUNCHES)
        _add_counts(total, counts)
        rep = out["lockcheck"]
        cycles = [v for v in rep["violations"] if "cycle" in v]
        held = [v for v in rep["violations"] if "held across dispatch" in v]
        print(f"[lockcheck 40] torch_soak --{mode} --lockcheck ({CARD}): {out['trials']} "
              f"trials in {out['seconds']:.1f} s, {out['fails']} failed; lockcheck "
              f"{rep['locks']} locks, {rep['acquisitions']} acquisitions, "
              f"{rep['order_edges']} order edges, {rep['stash_edges']} victim-stash edges, "
              f"{len(cycles)} lock-order cycles, {len(held)} locks held across dispatch; "
              f"launches {counts}", flush=True)
        for v in rep["violations"]:
            print(f"[lockcheck 40]   {v}", flush=True)
        check(out["trials"] >= 1 and out["fails"] == 0,
              f"lockcheck 40 --{mode}: {out['fails']} of {out['trials']} trials failed")
        check(not rep["violations"], f"lockcheck 40 --{mode}: {len(rep['violations'])} "
              "violations")
        check(counts["btrsm"] > 0 and counts["batched_lu"] > 0,
              f"lockcheck 40 --{mode}: K3 and K4 must both launch: {counts}")
    return total


SERVING_SOAKS = ("precision", "qos", "adaptive", "gang", "fleet", "mesh", "scale")


def phase_soaks() -> dict:
    """(43) `scripts/torch_soak.py` on the card, in this process, under
    `analysis.lockcheck`: the configuration soak for a time budget of 60 s
    (the grid programs on threaded worlds of grid.P ranks sharing the card
    over transport "staged"), then each serving mode for 10 s. Each must
    run at least one trial, fail none and read no lockcheck violation; the
    configuration soak must launch K1 (its "kernel"-backend float32 and
    bfloat16 draws), every serving mode K3 and K4. Prints trials, seconds,
    launches and the configuration soak's draws per core and dtype.
    Returns the launches."""
    from conflux_tpu_torch.ops import hopper_kernels as hk

    t_phase = time.perf_counter()
    mod = _script_module("scripts/torch_soak.py")
    mod.ENGINE["device"] = "cuda"
    mod.DRAWS.clear()
    total: dict = {}
    for mode, budget in (("config", 60.0),) + tuple((m, 10.0) for m in SERVING_SOAKS):
        torch.cuda.synchronize()
        hk.reset_launches()
        fails: list = []
        out = mod.soak(mode, trials=100000, seed=0, time_budget=budget, lockcheck=True,
                       emit=lambda m: fails.append(m) if m.startswith("FAIL") else None)
        torch.cuda.synchronize()
        counts = dict(hk.LAUNCHES)
        _add_launches(total, counts)
        rep = out["lockcheck"]
        print(f"[soaks 43] torch_soak {'--' + mode if mode != 'config' else '(configurations)'}"
              f" --lockcheck ({CARD}): {out['trials']} trials in {out['seconds']:.1f} s, "
              f"{out['fails']} failed, {len(rep['violations'])} lockcheck violations "
              f"({rep['locks']} locks, {rep['order_edges']} order edges); launches K1 "
              f"{counts['gemm']}, K2 {counts['lu_block']}, K3 {counts['btrsm']}, K4 "
              f"{counts['batched_lu']}, K5 {counts['batched_chol']}", flush=True)
        for line in fails + [f"LOCKCHECK {v}" for v in rep["violations"]]:
            print(f"[soaks 43]   {line}", flush=True)
        check(out["trials"] >= 1 and out["fails"] == 0,
              f"soaks 43 {mode}: {out['fails']} of {out['trials']} trials failed")
        check(not rep["violations"], f"soaks 43 {mode}: {len(rep['violations'])} lockcheck "
              "violations")
        if mode == "config":
            check(counts["gemm"] > 0, f"soaks 43: the configuration soak launched no K1: "
                  f"{counts}")
            draws: dict = {}
            for (core, dtype, backend), n in sorted(mod.DRAWS.items()):
                draws.setdefault(f"{core}/{dtype}", {})[backend] = n
            print(f"[soaks 43]   draws per core/dtype (backend: trials): {draws}", flush=True)
        else:
            check(counts["btrsm"] > 0 and counts["batched_lu"] > 0,
                  f"soaks 43 --{mode}: K3 and K4 must both launch: {counts}")
    torch.cuda.empty_cache()
    print(f"[soaks 43] phase {time.perf_counter() - t_phase:.1f} s, launches {total}",
          flush=True)
    return total


def _add_launches(total: dict, counts: dict) -> None:
    for k, n in counts.items():
        total[k] = total.get(k, 0) + int(n)


# TF32 on an H100 SXM: 495 TFLOP/s dense (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12


def _tf32_bar(K: int) -> float:
    """The TF32 bar of a K-deep product's error relative to its largest
    entry: TF32's eps (2^-10; unit roundoff 2^-11) times sqrt(K)."""
    from conflux_tpu_torch.validation import TF32_EPS

    return TF32_EPS * math.sqrt(K)


def _grid_lu_at(level: str, backend: str, geom, mesh, make) -> tuple:
    """(mean ms of 2 timed runs, residual, per-phase table of a traced run)
    of the grid LU at `level` on `backend`."""
    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.lu.distributed import lu_factor_distributed
    from conflux_tpu_torch.validation import lu_residual_distributed

    out = lu_factor_distributed(make(), geom, mesh, level, backend, donate=True)
    del out
    times = []
    for _ in range(2):
        A = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, perm = lu_factor_distributed(A, geom, mesh, level, backend, donate=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res = lu_residual_distributed(make(), out, perm, geom, mesh)
    del out, perm, A
    A = make()
    with tempfile.TemporaryDirectory(prefix="precision41-") as d:
        with profiler.trace(d):
            lu_factor_distributed(A, geom, mesh, level, backend, donate=True)
        table = profiler.phase_table(d, phase_re=profiler._PHASE_RE)
    del A
    torch.cuda.empty_cache()
    return sum(times) / len(times), res, table


def phase_precision() -> dict:
    """(41) Matmul precision on the card. (a) The TF32 library product
    (`blas.gemm(..., "high", "xla")`, one cuBLAS call with its own TF32
    compute type) at 8192x1024 . 1024x8192 f32: its error against a
    float64 product between 10x the IEEE product's and the TF32 bar, both
    times beside their bounds; the HIGHEST product bitwise `torch.matmul`
    with TF32 off. (b) Two threads, 200 rounds each, IEEE and TF32
    products at once: every IEEE result bitwise. (c) Kernel plans at
    DEFAULT bitwise their HIGHEST plans: a (32, 1024, 1024) f32 LU plan
    (K4, K3) and the HPL-MxP (4, 1024, 1024) plan with bf16 factors (K1,
    K2, K3), every first K1, K2, K3 and K4 call at each shape held
    against its plain version. (a') The grid programs' trailing update
    at HIGH, C -= A B in place into a block of a larger matrix (ldc > N;
    A and B strided views of the same matrix), 2D and batched: within
    the TF32 product bar of a float64 product, the rest untouched.
    (d) `lu_factor_distributed` at N=32768, v=1024, 1x1x1 on backend
    "xla" at HIGHEST and HIGH: ms, residual (HIGHEST within
    residual_bound(N, f32), HIGH within the TF32 bar) and the per-phase
    table (phase 39's machinery), step6_dgemm of each; HIGH's residual at
    N=8192 and 16384 within the bar; and two controls at N=32768 the bar
    must refuse: every TF32 product skipped, and operands rounded to
    bfloat16. (e) `solve_distributed` at N=16384 on backend "xla" against
    the 1e-6 bar of `scripts/accuracy_demo.py`: HIGHEST with 3 classic
    sweeps must reach it; the HIGH factor with 3 classic sweeps and under
    GMRES-IR (`ir="gmres"`) must reach it or warn: a TF32 factor's
    backward error is ~2^14 times float32's (0.3 at N=32768 on this
    matrix), past what either converges from. Returns the launches."""
    import threading
    import warnings

    from conflux_tpu_torch import serve
    from conflux_tpu_torch.geometry import Grid3, LUGeometry
    from conflux_tpu_torch.ops import blas
    from conflux_tpu_torch.ops import hopper_kernels as hk
    from conflux_tpu_torch.parallel.mesh import make_mesh
    from conflux_tpu_torch.lu.distributed import lu_factor_distributed
    from conflux_tpu_torch.solvers import solve_distributed
    from conflux_tpu_torch.validation import TF32_EPS, lu_residual_distributed, residual_bound

    t_phase = time.perf_counter()
    total: dict = {}
    # (a) the product
    M, K, N = 8192, 1024, 8192
    g = torch.Generator(device="cuda").manual_seed(41)
    a = torch.randn((M, K), generator=g, device="cuda")
    b = torch.randn((K, N), generator=g, device="cuda")
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    calls = blas.TF32_CALLS
    tf = blas.gemm(a, b, None, 1.0, 1.0, "high", "xla")
    ie = blas.gemm(a, b, None, 1.0, 1.0, "highest", "xla")
    torch.cuda.synchronize()
    err_tf = float((tf.double() - ref).abs().max()) / scale
    err_ie = float((ie.double() - ref).abs().max()) / scale
    bar = _tf32_bar(K)
    ms_tf = time_ms(lambda: blas.gemm(a, b, None, 1.0, 1.0, "high", "xla"), 10)
    ms_ie = time_ms(lambda: blas.gemm(a, b, None, 1.0, 1.0, "highest", "xla"), 10)
    flops = 2.0 * M * N * K
    nbytes = 4.0 * (M * K + K * N + M * N)
    bound_tf = 1e3 * max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES)
    bound_ie = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    print(f"[precision 41] {M}x{K}.{K}x{N} f32 ({CARD}): TF32 (HIGH) {ms_tf:.3f} ms = "
          f"{flops / ms_tf / 1e9:.1f} TFLOP/s (bound {bound_tf:.3f} ms), IEEE (HIGHEST) "
          f"{ms_ie:.3f} ms = {flops / ms_ie / 1e9:.1f} TFLOP/s (bound {bound_ie:.3f} ms); max "
          f"error over max |A B| against float64: TF32 {err_tf:.3e}, IEEE {err_ie:.3e}, TF32 "
          f"bar {bar:.3e}; TF32 library calls {blas.TF32_CALLS - calls}", flush=True)
    check(10 * err_ie <= err_tf <= bar,
          f"precision 41: TF32 error {err_tf:.3e} not in [10 x {err_ie:.3e}, {bar:.3e}]")
    check(blas.TF32_CALLS - calls == 12, "precision 41: HIGH did not take the TF32 product")
    same = torch.equal(ie, a @ b)
    print(f"[precision 41]   HIGHEST bitwise torch.matmul with TF32 off {same} "
          f"(allow_tf32 {torch.backends.cuda.matmul.allow_tf32})", flush=True)
    check(same and not torch.backends.cuda.matmul.allow_tf32,
          "precision 41: the HIGHEST product is not IEEE torch.matmul")
    # (b) two threads
    a2, b2 = a[:2048].contiguous(), b[:, :2048].contiguous()
    want = blas.gemm(a2, b2, None, 1.0, 1.0, "highest", "xla")
    torch.cuda.synchronize()
    bad: list = []
    tf_done: list = []

    def ieee():
        torch.cuda.set_device(a2.device)
        for i in range(200):
            if not torch.equal(blas.gemm(a2, b2, None, 1.0, 1.0, "highest", "xla"), want):
                bad.append(i)

    def tf32():
        torch.cuda.set_device(a2.device)
        for _ in range(200):
            blas.gemm(a2, b2, None, 1.0, 1.0, "high", "xla")
        tf_done.append(True)

    threads = [threading.Thread(target=ieee), threading.Thread(target=tf32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    print(f"[precision 41]   two threads, 200 IEEE and 200 TF32 products at once: IEEE "
          f"results not bitwise {len(bad)}", flush=True)
    check(not bad and tf_done, f"precision 41: {len(bad)} IEEE products changed under TF32")
    del a, b, ref, tf, ie, a2, b2, want
    torch.cuda.empty_cache()
    # (a') the grid programs' trailing update: in place into a block of a
    # larger matrix, operands strided views of the same matrix
    for shape, k, w in (((8192, 12288), 1024, 1024), ((4, 2048, 3072), 256, 256)):
        S = torch.randn(shape, generator=g, device="cuda")
        S0 = S.clone()
        L21 = S[..., k + w:, k:k + w]
        U12 = S[..., k:k + w, k + w:]
        A22 = S[..., k + w:, k + w:]
        prod = L21.double() @ U12.double()
        want = A22.double() - prod
        scale = float(prod.abs().max())
        del prod
        calls = blas.TF32_CALLS
        blas.gemm(L21, U12, A22, -1.0, 1.0, "high", "xla", out=A22)
        torch.cuda.synchronize()
        err = float((A22.double() - want).abs().max()) / scale
        outside = torch.ones_like(S, dtype=torch.bool)
        outside[..., k + w:, k + w:] = False
        kept = torch.equal(S[outside], S0[outside])
        sbar = _tf32_bar(w)
        print(f"[precision 41]   TF32 C -= A B in place, C {tuple(A22.shape)} of "
              f"{tuple(S.shape)} (ldc {A22.stride(-2)}), A and B strided views: error over "
              f"max |A B| {err:.3e} (bar {sbar:.3e}), rest untouched {kept}", flush=True)
        check(err <= sbar and kept and blas.TF32_CALLS == calls + 1,
              f"precision 41: strided TF32 update {tuple(S.shape)}: error {err:.3e}, "
              f"untouched {kept}")
        del S, S0, L21, U12, A22, want, outside
        torch.cuda.empty_cache()
    # (c) kernel plans at DEFAULT
    rng_g = torch.Generator(device="cpu").manual_seed(42)
    A = (torch.randn((32, 1024, 1024), generator=rng_g) / 32 + 2 * torch.eye(1024)).cuda()
    rhs = torch.randn((32, 1024), generator=rng_g).cuda()
    serve.clear_plans()
    torch.cuda.synchronize()
    hk.reset_launches()
    outs = {}
    with _held_to_plain("precision 41", ("gemm", "lu_block", "btrsm", "batched_lu")):
        for level in ("default", None):
            p1 = serve.FactorPlan.create((32, 1024, 1024), torch.float32, v=256,
                                         precision=level)
            p2 = serve.FactorPlan.create((4, 1024, 1024), torch.float32, v=256,
                                         factor_dtype=torch.bfloat16, refine=2,
                                         precision=level)
            outs[level] = (p1.factor(A).solve(rhs), p2.factor(A[:4]).solve(rhs[:4]))
        torch.cuda.synchronize()
    counts = dict(hk.LAUNCHES)
    _add_launches(total, counts)
    same = all(torch.equal(x, y) for x, y in zip(outs["default"], outs[None]))
    print(f"[precision 41]   kernel plans at DEFAULT bitwise their HIGHEST plans {same} "
          f"((32, 1024, 1024) LU; (4, 1024, 1024) bf16 factors, refine 2); launches {counts}",
          flush=True)
    check(same, "precision 41: a DEFAULT kernel plan differs from its HIGHEST plan")
    check(all(counts[k] > 0 for k in ("gemm", "lu_block", "btrsm", "batched_lu")),
          f"precision 41: a kernel of the plans never launched: {counts}")
    del A, rhs, outs
    serve.clear_plans()
    torch.cuda.empty_cache()
    # (d) the grid LU on backend "xla" at HIGHEST and HIGH
    n, v = 32768, 1024
    grid = Grid3(1, 1, 1)
    geom = LUGeometry.create(n, n, v, grid)
    mesh = make_mesh(grid)

    def make():
        gen = torch.Generator(device="cuda").manual_seed(0)
        A = torch.randn((n, n), generator=gen, device="cuda")
        A.diagonal().add_(2.0)
        return A

    rows = {}
    for level in ("highest", "high"):
        hk.reset_launches()
        calls = blas.TF32_CALLS
        ms, res, table = _grid_lu_at(level, "xla", geom, mesh, make)
        counts = dict(hk.LAUNCHES)
        _add_launches(total, counts)
        rows[level] = (ms, res, table)
        lbar = residual_bound(n, torch.float32, precision=level)
        print(f"[precision 41] grid LU N=32768 v=1024 f32 1x1x1 backend xla precision "
              f"{level} ({CARD}): {ms:.1f} ms = {2 / 3 * n ** 3 / ms / 1e6:.1f} GFLOP/s, "
              f"residual {res:.3e} (bar {lbar:.3e}), TF32 calls {blas.TF32_CALLS - calls}, "
              f"launches {counts}", flush=True)
        print(f"[precision 41]   phases (device ms, events): "
              + ", ".join(f"{k} {t[0]:.1f} ({t[1]})" for k, t in sorted(table.items())),
              flush=True)
        check(math.isfinite(res) and res <= lbar,
              f"precision 41: grid LU at {level} residual {res:.3e} > {lbar:.3e}")
        check(counts["gemm"] == 0 and counts["lu_block"] > 0,
              f"precision 41: the xla grid LU ran K1 or no K2: {counts}")
        check((blas.TF32_CALLS > calls) == (level == "high"),
              f"precision 41: TF32 calls at {level}: {blas.TF32_CALLS - calls}")
    # the TF32 bar's readings: sound HIGH factors at two smaller N, and two
    # factors the bar must refuse (every TF32 product skipped; operands
    # rounded to bfloat16, 8x TF32's roundoff)
    for n_s in (8192, 16384):
        geom_s = LUGeometry.create(n_s, n_s, v, grid)

        def make_s(n_s=n_s):
            gen = torch.Generator(device="cuda").manual_seed(0)
            A = torch.randn((n_s, n_s), generator=gen, device="cuda")
            A.diagonal().add_(2.0)
            return A

        out, perm = lu_factor_distributed(make_s(), geom_s, mesh, "high", "xla", donate=True)
        res = lu_residual_distributed(make_s(), out, perm, geom_s, mesh)
        sbar = residual_bound(n_s, torch.float32, precision="high")
        print(f"[precision 41]   grid LU N={n_s} HIGH residual {res:.3e} = "
              f"{res / (math.sqrt(n_s) * TF32_EPS):.2f} sqrt(N) 2^-10 (bar {sbar:.3e})",
              flush=True)
        check(res <= sbar, f"precision 41: grid LU N={n_s} HIGH residual {res:.3e} > {sbar:.3e}")
        del out, perm
    real = blas.tf32_gemm

    def skipped(a, b, c=None, alpha=1.0, beta=1.0, *, out=None):
        if c is not None and out is c and beta == 1.0:
            return c
        shape = (*torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]), a.shape[-2], b.shape[-1])
        res = a.new_zeros(shape) if c is None else (beta * c).expand(shape)
        return res if out is None else out.copy_(res)

    def coarse(a, b, c=None, alpha=1.0, beta=1.0, *, out=None):
        return real(a.to(torch.bfloat16).to(a.dtype), b.to(torch.bfloat16).to(b.dtype), c,
                    alpha, beta, out=out)

    hbar = residual_bound(n, torch.float32, precision="high")
    for label, fake in (("TF32 products skipped", skipped),
                        ("operands rounded to bfloat16", coarse)):
        blas.tf32_gemm = fake
        try:
            out, perm = lu_factor_distributed(make(), geom, mesh, "high", "xla", donate=True)
        finally:
            blas.tf32_gemm = real
        res = lu_residual_distributed(make(), out, perm, geom, mesh)
        print(f"[precision 41]   grid LU N={n} HIGH, {label} (a control the bar must "
              f"refuse): residual {res:.3e} (bar {hbar:.3e})", flush=True)
        check(not res <= hbar, f"precision 41: the TF32 bar passed a factor with {label}")
        del out, perm
        torch.cuda.empty_cache()
    s_hi = rows["highest"][2].get("step6_dgemm", (float("nan"), 0))[0]
    s_tf = rows["high"][2].get("step6_dgemm", (float("nan"), 0))[0]
    print(f"[precision 41]   step6_dgemm HIGHEST {s_hi:.1f} ms, HIGH {s_tf:.1f} ms; factor "
          f"{rows['highest'][0]:.1f} -> {rows['high'][0]:.1f} ms; residual "
          f"{rows['highest'][1]:.3e} -> {rows['high'][1]:.3e} "
          f"(x{rows['high'][1] / rows['highest'][1]:.0f})", flush=True)
    # (e) the refined solve at HIGH: classic sweeps and GMRES-IR, beside
    # HIGHEST's classic sweeps (accuracy_demo.py's recipe)
    n2 = 16384
    gen = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn((n2, n2), generator=gen, device="cuda")
    A.diagonal().add_(2.0)
    rhs = torch.ones(n2, device="cuda")
    solved, warned = {}, {}
    for label, kw in (("highest classic refine 3", dict(refine=3, precision="highest")),
                      ("high classic refine 3", dict(refine=3, precision="high")),
                      ("high gmres", dict(ir="gmres", tol=1e-7, precision="high"))):
        hk.reset_launches()
        calls = blas.TF32_CALLS
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            x = solve_distributed(A, rhs, grid=grid, v=v, backend="xla", **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(hk.LAUNCHES)
        _add_launches(total, counts)
        r = rhs.double() - A.double() @ x
        rel = float(torch.linalg.norm(r) / torch.linalg.norm(rhs.double()))
        solved[label] = rel
        warned[label] = any(issubclass(w.category, RuntimeWarning) for w in caught)
        print(f"[precision 41] solve_distributed N=16384 v=1024 backend xla {label}: "
              f"||A x - b|| / ||b|| {rel:.3e} (accuracy_demo.py's bar 1e-6), {secs:.2f} s, "
              f"TF32 calls {blas.TF32_CALLS - calls}, launches {counts}"
              + "".join(f"; {w.message}" for w in caught), flush=True)
        del x, r
    check(solved["highest classic refine 3"] <= 1e-6,
          f"precision 41: HIGHEST refine 3 reached {solved['highest classic refine 3']:.3e}")
    # no silent miss: a HIGH solve reaches the bar or warns (classic sweeps
    # that diverged, a GMRES-IR stall)
    check(all(rel <= 1e-6 or warned[label] for label, rel in solved.items()),
          f"precision 41: a refined solve missed 1e-6 without a warning: {solved}, "
          f"warned {warned}")
    del A, rhs
    torch.cuda.empty_cache()
    print(f"[precision 41] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def phase_sweep() -> dict:
    """(42) The tuning sweep (`scripts/torch_tune.py`) on the card: LU at
    N=32768 on 1x1x1 with --reps 1 over a short config list (HIGHEST and
    HIGH at chunk 8192, v=1024; HIGHEST at chunk 4096; HIGHEST with the
    autotune rule's segs 4x4), once on the default "kernel" backend and
    once on "xla", where HIGH is the TF32 product. Every config must run
    within the bar of its precision: residual_bound(N, f32), or the TF32
    bar where it ran TF32. Prints the rule's 4x4 beside the default
    segments on each backend. Returns the launches."""
    from conflux_tpu_torch.ops import blas
    from conflux_tpu_torch.ops import hopper_kernels as hk

    t_phase = time.perf_counter()
    mod = _script_module("scripts/torch_tune.py")
    total: dict = {}
    prev = blas.get_backend()
    rows: list = []
    try:
        for backend in ("kernel", "xla"):
            blas.set_backend(backend)
            torch.cuda.synchronize()
            hk.reset_launches()
            print(f"[sweep 42] torch_tune.py on backend {backend} ({CARD}):", flush=True)
            rc = mod.main(["-N", "32768", "--reps", "1", "--configs",
                           "highest:8192:1024,high:8192:1024,highest:4096:1024,"
                           "highest:8192:1024:4x4"], rows)
            torch.cuda.synchronize()
            counts = dict(hk.LAUNCHES)
            _add_launches(total, counts)
            check(rc == 0, f"sweep 42: torch_tune.py on {backend} exited {rc}")
            print(f"[sweep 42]   launches {counts}", flush=True)
            check(counts["lu_block"] > 0 and (counts["gemm"] > 0) == (backend == "kernel"),
                  f"sweep 42: launches on {backend}: {counts}")
    finally:
        blas.set_backend(prev)
    check(len(rows) == 8 and all(r["meets_bar"] for r in rows),
          f"sweep 42: {len(rows)} configs, one missed the bar of its precision: "
          + ", ".join(f"{r['backend']} {r['precision']} {r['residual']:.3e}" for r in rows))
    for backend in ("kernel", "xla"):
        lib, rule = (next(r for r in rows if r["backend"] == backend and r["precision"]
                          == "highest" and r["panel_chunk"] == 8192 and r["segs"] == segs)
                     for segs in (None, (4, 4)))
        print(f"[sweep 42]   {backend}: the autotune rule's segs 4x4 {rule['gflops']:.1f} "
              f"GFLOP/s against the default 16x16's {lib['gflops']:.1f} (--reps 1)", flush=True)
    torch.cuda.empty_cache()
    print(f"[sweep 42] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


# --------------------------------------------------------------------------- #
# 44-46: the reference's user scripts on the card
# --------------------------------------------------------------------------- #

DEMO_BAR = 1e-6  # BASELINE.md's solve bar at N >= 16384, float32 factors


def phase_accuracy_demo() -> dict:
    """(44) `scripts/torch_accuracy_demo.py`'s sweeps at N=16384, v=1024 on
    the card: randn + 2 I (a generator seeded 0), b = 1, float32 factors
    then bfloat16 factors (in both, every first K1 and K2 call at each
    shape held against the plain versions), each factored once and refined to
    depths 0, 2 and 4 with float64 strip residuals. The float32 residual at
    depth 4 must be <= 1e-6 (bfloat16 prints with no bar, as the
    reference's), A must be intact after each donated factorization, and
    K1 and K2 must launch in both runs. Returns the launches."""
    from conflux_tpu_torch.ops import hopper_kernels as hk

    t_phase = time.perf_counter()
    mod = _script_module("scripts/torch_accuracy_demo.py")
    N, v, depths = 16384, 1024, (0, 2, 4)
    A = mod.make_matrix(N, "cuda")
    A0 = A.clone()
    b = torch.ones(N, device="cuda")
    total: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        torch.cuda.synchronize()
        hk.reset_launches()
        with _held_to_plain(f"demo 44 {name}"):
            res = mod.accuracy_sweeps(A, b, v, depths, dtype, "cuda")
        torch.cuda.synchronize()
        counts = dict(hk.LAUNCHES)
        _add_launches(total, counts)
        print(f"[demo 44] torch_accuracy_demo N={N} v={v} factors={name} ({CARD}): "
              + ", ".join(f"refine {d} {res['rel'][d]:.3e} ({res['seconds'][d]:.2f} s)"
                          for d in depths)
              + f"; launches K1 {counts['gemm']}, K2 {counts['lu_block']}", flush=True)
        check(torch.equal(A, A0), f"demo 44 {name}: A changed by the donated factorization")
        check(counts["gemm"] > 0 and counts["lu_block"] > 0,
              f"demo 44 {name}: K1 and K2 must both launch: {counts}")
        if dtype == torch.float32:
            check(res["rel"][4] <= DEMO_BAR, f"demo 44: float32 factors reached "
                  f"{res['rel'][4]:.3e} at refine 4, above {DEMO_BAR:g}")
    del A, A0, b
    torch.cuda.empty_cache()
    print(f"[demo 44] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def phase_tour() -> dict:
    """(45) `examples/torch_tour.py` on the card: the eight steps on
    threaded worlds of 8 (2x2x2), 4 (4x1x1) and 6 (3x2x1) ranks sharing
    cuda:0 over the "staged" transport, every bar of the JAX tour checked by
    the tour itself (a miss raises), every first K1 and K2 call at each
    shape held against the plain versions; K1 and K2 must launch. Returns
    the launches."""
    from conflux_tpu_torch.ops import hopper_kernels as hk

    t_phase = time.perf_counter()
    mod = _script_module("examples/torch_tour.py")
    torch.cuda.synchronize()
    hk.reset_launches()
    with _held_to_plain("tour 45"):
        out = mod.main()
    torch.cuda.synchronize()
    counts = dict(hk.LAUNCHES)
    keys = ("lu_residual", "solve_residual", "bf16_residual", "bf16_ir_residual",
            "gmres_residual", "cholesky_residual", "hermitian_residual", "restart_residual",
            "tsqr_orth", "cholesky_orth", "full_qr_rec", "lstsq_optimality",
            "qr_lstsq_residual", "odd_residual")
    print(f"[tour 45] torch_tour on the card ({CARD}): "
          + ", ".join(f"{k} {out[k]:.3e}" for k in keys)
          + f"; autotune v {out['autotune_v']}; launches K1 {counts['gemm']}, K2 "
          f"{counts['lu_block']}, K3 {counts['btrsm']}, K4 {counts['batched_lu']}, K5 "
          f"{counts['batched_chol']}", flush=True)
    check(counts["gemm"] > 0 and counts["lu_block"] > 0,
          f"tour 45: K1 and K2 must both launch: {counts}")
    torch.cuda.empty_cache()
    print(f"[tour 45] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def phase_replay() -> dict:
    """(46) `scripts/torch_replay.py --smoke` on the card, in this process:
    leg (a) on a 2000-session metadata fleet, leg (b) 2000 N=48 sessions on
    two LocalHost engines of cuda:0 at 5 device slots each under a 10 s
    open-loop trace, the checkpoint contrast and the oracle spot checks,
    leg (c) 96 sessions on three hosts under the tier fault menu with a
    host killed mid-traffic. Every reference smoke gate must pass (speedup
    >= 1.5, attainment >= 90%, capacity >= 100x the device slots, no
    invariant broken: high-water <= cap, 0 lost, census exact, sampled
    survivors within the oracle), every first K3 and K4 call at each shape
    held against the plain versions, and K3 and K4 must launch. Returns the
    launches."""
    from conflux_tpu_torch.ops import hopper_kernels as hk

    t_phase = time.perf_counter()
    mod = _script_module("scripts/torch_replay.py")
    rec: dict = {}
    torch.cuda.synchronize()
    hk.reset_launches()
    with _held_to_plain("replay 46", ("btrsm", "batched_lu")):
        rc = mod.main(["--smoke"], rec)
    torch.cuda.synchronize()
    counts = dict(hk.LAUNCHES)
    cap, ch = rec["capacity_model"], rec["chaos"]
    print(f"[replay 46] torch_replay --smoke ({CARD}): speedup {rec['value']}x (gate "
          f"{rec['speedup_gate_x']}), attainment {rec['slo_attainment_pct']}% (gate "
          f"{rec['attainment_gate_pct']}%) over {rec['trace']['requests']} requests "
          f"({json.dumps(rec['trace']['by_class'])}), capacity {cap['capacity_ratio_x']}x "
          f"(gate {cap['capacity_gate_x']}x), open {cap['open_s']} s, resident high-water "
          f"{rec['memory']['resident_high_water']} of cap {rec['memory']['resident_cap']}, "
          f"census {rec['census']}, oracle {rec['oracle']}, checkpoint "
          f"{rec['checkpoint']}, churn {rec['churn']}, gang {rec['gang']}", flush=True)
    print(f"[replay 46]   chaos: killed {ch['killed_host']}, recoveries {ch['recoveries']} "
          f"(max {ch['recovery_s_max']:.3f} s), lost {ch['lost_sessions']}, census "
          f"{ch['census']}, oracle {ch['oracle_sessions']} sessions {ch['oracle_failures']} "
          f"failed, trace {ch['trace']}, faults {ch['faults_injected']}", flush=True)
    print(f"[replay 46]   gates {rec['gates']}, violations {rec['violations']}; launches "
          f"K3 {counts['btrsm']}, K4 {counts['batched_lu']}, K5 {counts['batched_chol']}",
          flush=True)
    check(rc == 0 and not rec["violations"],
          f"replay 46: gates {rec['gates']}, violations {rec['violations']}")
    check(counts["btrsm"] > 0 and counts["batched_lu"] > 0,
          f"replay 46: K3 and K4 must both launch: {counts}")
    torch.cuda.empty_cache()
    print(f"[replay 46] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def main() -> int:
    device = phase_device()
    # importing the port only after the card check: without a card, or in a
    # directory without the package, the script fails before any result
    import conflux_tpu_torch  # noqa: F401

    phase_build()
    k1 = {"name": "gemm", "route": "cuda",
          "source": "conflux_tpu_torch/ops/csrc/gemm.cu",
          "replaces": "conflux_tpu/ops/pallas_kernels.py:38"}
    k2 = {"name": "lu_block", "route": "cuda",
          "source": "conflux_tpu_torch/ops/csrc/lu_block.cu",
          "replaces": "conflux_tpu/ops/pallas_kernels.py:153"}
    from conflux_tpu_torch.ops import blas  # noqa: F401 (sets the TF32 flags)

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    phase_k1(k1)
    torch.cuda.empty_cache()
    phase_k2(k2)
    torch.cuda.empty_cache()
    counts, kernel_ms = phase_main()
    k1["launches"], k2["launches"] = counts["gemm"], counts["lu_block"]
    k3 = {"name": "btrsm", "route": "cuda",
          "source": "conflux_tpu_torch/ops/csrc/btrsm.cu",
          "replaces": "conflux_tpu/ops/batched_trsm.py:305"}
    k4 = {"name": "batched_lu", "route": "cuda",
          "source": "conflux_tpu_torch/ops/csrc/batched_lu.cu",
          "replaces": "conflux_tpu/ops/pallas_factor.py:214"}
    phase_k3(k3)
    phase_k4(k4)
    torch.cuda.empty_cache()
    ca = phase_serve_a()
    cb = phase_serve_b()
    k5 = {"name": "batched_chol", "route": "cuda",
          "source": "conflux_tpu_torch/ops/csrc/batched_chol.cu",
          "replaces": "conflux_tpu/ops/pallas_factor.py:256"}
    phase_k5(k5)
    torch.cuda.empty_cache()
    cc = phase_serve_c()
    cd = phase_serve_d()
    torch.cuda.empty_cache()
    cm = phase_chol_main()
    phase_l64()
    phase_lxla32(kernel_ms)
    phase_c64()
    ce = phase_serve_e()
    cf = phase_serve_f(k3)
    phase_solvers()
    cw = phase_woodbury()
    cl = phase_ladder()
    c23 = phase_qr()
    phase_qr_lane()
    c25 = phase_engine_solve()
    c26 = phase_engine_factor()
    c27 = phase_engine_gang()
    c28 = phase_tier()
    c29 = phase_ckpt()
    c30 = phase_controller()
    c31 = phase_fabric()
    c32 = phase_dist_lu(kernel_ms)
    c33 = phase_dist_chol()
    c34 = phase_dist_ranks()
    c35 = phase_dist_qr()
    c36 = phase_dist_qr_ranks()
    c37 = phase_mesh()
    c38 = phase_lanes()
    c39 = phase_phase_tables()
    c40 = phase_lockcheck_soaks()
    c41 = phase_precision()
    c42 = phase_sweep()
    c43 = phase_soaks()
    c44 = phase_accuracy_demo()
    c45 = phase_tour()
    c46 = phase_replay()
    late = (c23, c28, c29, c30, c31, c32, c33, c34, c35, c36, c37, c38, c39, c40, c41, c42,
            c43, c44, c45, c46)
    k1["launches"] += cm["gemm"] + cf["gemm"] + cl["gemm"] + sum(c.get("gemm", 0) for c in late)
    k2["launches"] += cf["lu_block"] + cl["lu_block"] + sum(c.get("lu_block", 0) for c in late)
    k3["launches"] = (ca["btrsm"] + cb["btrsm"] + cc["btrsm"] + cd["btrsm"] + ce["btrsm"]
                      + cf["btrsm"] + cw["btrsm"] + cl["btrsm"] + c25["btrsm"]
                      + c26["btrsm"] + c27["btrsm"] + sum(c.get("btrsm", 0) for c in late))
    k4["launches"] = (ca["batched_lu"] + cb["batched_lu"] + cw["batched_lu"]
                      + cl["batched_lu"] + c26["batched_lu"]
                      + sum(c.get("batched_lu", 0) for c in late))
    k5["launches"] = (cc["batched_chol"] + cd["batched_chol"] + c26["batched_chol"]
                      + sum(c.get("batched_chol", 0) for c in late))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in (k1, k2, k3, k4, k5)]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
