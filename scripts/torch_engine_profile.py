"""Where the serving engine's time goes on the card: the device's idle
share under the solve lane's traffic.

    python scripts/torch_engine_profile.py [--legs 3] [--out PATH]

Drives chip_smoke.py phase 25's traffic (two sessions of a (32, 256, 256)
f32 LU plan and one of a (256, 256) plan, v=128, 128 requests of widths
1,1,2,4, max_coalesce_width 32, max_batch_delay 2 ms) through a prewarmed
`ServeEngine`, first without and then under `torch.profiler`. Prints each
untraced leg's wall time and its requests' p50/p99 latency (host clock,
`profiler.StatsWindow`; the first leg follows the prewarm directly), the
device's busy time in the traced leg
(the union of the kernel and copy intervals in the trace), the idle share
1 - busy / wall of that leg, and the device's top operations. A trace
without device activity prints "not measured". With --out, writes the
numbers as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser("torch_engine_profile")
    ap.add_argument("--legs", type=int, default=3, help="untraced legs timed first")
    ap.add_argument("--out", default=None, help="write the numbers as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_engine_profile: needs an NVIDIA card")
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from conflux_tpu_torch import profiler, serve
    from conflux_tpu_torch.engine import ServeEngine

    B, n, R = 32, 256, 128
    serve.clear_plans()
    bplan = serve.FactorPlan.create((B, n, n), torch.float32, v=128)
    splan = serve.FactorPlan.create((n, n), torch.float32, v=128)
    sessions = [bplan.factor(cs._systems(B, n, 250)), bplan.factor(cs._systems(B, n, 251)),
                splan.factor(cs._systems(1, n, 252)[0])]
    trace = cs._engine_trace(sessions, R, cs.ENGINE_WIDTHS, 25)
    with ServeEngine(max_batch_delay=0.002, max_coalesce_width=32) as eng:
        for s in sessions:
            eng.prewarm(s, widths=(1, 2, 4, 8, 16, 32))
        win = profiler.StatsWindow(eng)
        legs, tails = [], []
        for _ in range(args.legs):
            legs.append(cs._engine_leg(eng, trace)[1])
            d = win.delta()["engine"]
            tails.append((d["latency_p50_ms"], d["latency_p99_ms"]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cs._engine_leg(eng, trace)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        st = eng.stats()
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in device_events])
    top: dict = {}
    for e in device_events:
        top[e.name] = top.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(smi.strip().splitlines()[0] if smi.strip() else "nvidia-smi: no output")
    print(f"[engine profile] untraced legs of {R} requests ({R / sorted(legs)[len(legs) // 2]:.1f} "
          f"solves/s, median): " + "; ".join(
              f"{1e3 * s:.3f} ms (p50 {p50:.3f}, p99 {p99:.3f} ms)"
              for s, (p50, p99) in zip(legs, tails))
          + f"; batches {st['batches']}, coalesced mean {st['coalesced_mean']:.2f}")
    out = {"requests": R, "untraced_leg_ms": [1e3 * s for s in legs],
           "untraced_leg_p50_p99_ms": tails,
           "traced_leg_ms": 1e3 * wall_s, "device_events": len(device_events)}
    if not device_events:
        print(f"[engine profile] traced leg {1e3 * wall_s:.3f} ms; device busy time: not "
              "measured (the trace holds no device activity)")
        out["device_busy_ms"] = out["idle_share"] = None
    else:
        idle = 1.0 - busy_us / (1e6 * wall_s)
        print(f"[engine profile] traced leg {1e3 * wall_s:.3f} ms; device busy "
              f"{busy_us / 1e3:.3f} ms over {len(device_events)} device operations; idle "
              f"share {idle:.4f}")
        for name, us in sorted(top.items(), key=lambda kv: -kv[1])[:8]:
            print(f"[engine profile]   {us / 1e3:9.3f} ms  {name[:90]}")
        out["device_busy_ms"] = busy_us / 1e3
        out["idle_share"] = idle
        out["top_device_ms"] = {k: v / 1e3 for k, v in
                                sorted(top.items(), key=lambda kv: -kv[1])[:8]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
