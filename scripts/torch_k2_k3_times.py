"""Times of K2 (`lu_block`) and K3 (`btrsm`, and a whole solve round) of
one checkout's `conflux_tpu_torch`, on the card.

    python scripts/torch_k2_k3_times.py [--root DIR]

`--root` imports the package from another checkout, so that two commits
can be compared on one card in one call: run parent, change, change,
parent. K2 at the LU main path's shapes ((1, 4096), (8, 4096) and
(4, 2048) blocks of 128 columns), the best of three CUDA-event timings
of 20 launches. K3 on K4's packed LUs of serving's systems at (32, 256,
256) and (32, 1024, 1024) with one right-hand side and (32, 256, 256)
with 16: one substitution (lower unit), and an LU solve round on b[perm]
(`btrsm_pair` where the checkout has it, else the gather and the two
substitutions the serving round ran before it). Each K3 time twice: CUDA
events around 20 calls of the Python entry (the wrapper's host time
included where the card waits for it) and the device time of the same 20
calls captured in one CUDA graph and replayed; and the host's time a call,
200 calls on the host clock with no wait for the card (`*_host`), and for
one substitution that of the bare C entry called through ctypes with its
operands ready (`single_c_host`), so that the wrapper's Python is the
difference. Prints one JSON line with the card's name and power limit.
Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def _events_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _graph_ms(fn, iters: int = 20) -> float:
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
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _host_us(fn, iters: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def _c_entry(lib, LU, Dl, b):
    """The bare C entry of one lower substitution, operands ready: this
    checkout's ABI (a mode and no column tile) or the one before it."""
    B, n, k = b.shape
    x = torch.empty_like(b)
    s = torch.cuda.current_stream().cuda_stream
    ptrs = (LU.data_ptr(), Dl.data_ptr())
    if len(lib.conflux_btrsm.argtypes) > 14:
        args = (0, 0, B, n, Dl.shape[1], Dl.shape[-1], k, 0, 0, *ptrs, None, b.data_ptr(),
                None, None, x.data_ptr(), None, None, s)
    else:
        args = (0, 0, B, n, Dl.shape[1], Dl.shape[-1], k, min(k, 16), 1, *ptrs, b.data_ptr(),
                x.data_ptr(), s)
    return lambda: lib.conflux_btrsm(*args)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("torch_k2_k3_times", description=__doc__)
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   help="checkout whose conflux_tpu_torch is imported")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_k2_k3_times needs an NVIDIA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from conflux_tpu_torch.ops import _build
    from conflux_tpu_torch.ops import hopper_kernels as hk
    from conflux_tpu_torch.ops.batched_trsm import diag_block_inverses

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"root": os.path.abspath(args.root), "nvidia_smi": smi, "k2_ms": {}, "k3_us": {}}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for B, m in ((1, 4096), (8, 4096), (4, 2048)):
        chunk = torch.rand((B, m, 1024), generator=gen, device="cuda") * 2 - 1
        chunk[:, ::8, 128:256] += 2.0
        blk = chunk[:, :, 128:256]  # a strided view, as the panel passes it
        ones = torch.ones((B, m, 1), dtype=torch.int32, device="cuda")
        x, al = (blk[0], ones[0]) if B == 1 else (blk, ones)
        out["k2_ms"][f"({B}, {m}, 128)"] = min(_events_ms(lambda: hk.lu_block(x, al))
                                               for _ in range(3))
    rng = np.random.default_rng(0)
    lib = _build.load()
    for n, k in ((256, 1), (1024, 1), (256, 16)):
        A = rng.standard_normal((32, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
        LU, perm, _ = hk.batched_lu(torch.from_numpy(A).to("cuda", torch.float32))
        Dl = diag_block_inverses(LU, lower=True, unit_diagonal=True)
        Du = diag_block_inverses(LU, lower=False)
        b = torch.from_numpy(rng.standard_normal((32, n, k)).astype(np.float32)).cuda()
        if hasattr(hk, "btrsm_pair"):
            def rnd():
                return hk.btrsm_pair(LU, Dl, Du, b, perm=perm)
        else:
            def rnd():
                r = torch.gather(b, -2, perm[..., None].expand(b.shape))
                return hk.btrsm(LU, Du, hk.btrsm(LU, Dl, r, lower=True), lower=False)

        def one():
            return hk.btrsm(LU, Dl, b, lower=True)

        out["k3_us"][f"(32, {n}, {n}) k={k}"] = {
            "single_events": _events_ms(one) * 1e3, "single_graph": _graph_ms(one) * 1e3,
            "single_host": _host_us(one),
            "single_c_host": _host_us(_c_entry(lib, LU, Dl, b)),
            "round_events": _events_ms(rnd) * 1e3, "round_graph": _graph_ms(rnd) * 1e3,
            "round_host": _host_us(rnd)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
