"""Twins of tests/test_wire.py for the port's shared-memory wire
(`conflux_tpu_torch/wire.py`), and its parity with the JAX package's.

The port's copy must put the same bytes on the wire as the reference:
for the same sequence of `stage` calls on fresh rings of equal capacity
both segments hold equal bytes, and each package's `Ring.attach` reads
the other's records bitwise. The loopback through a port engine
(`device="cpu"`) answers bitwise the session's direct solve, and within
1e-5 (f32) of the JAX package's loopback on the same seeded inputs.
"""


import os
import time
from concurrent.futures import Future

import numpy as np
import pytest

from conflux_tpu import wire as ref_wire
from conflux_tpu_torch import wire as wire_mod
from conflux_tpu_torch.resilience import FaultPlan, FaultSpec, WireCorrupt
from conflux_tpu_torch.wire import InProcWire, Ring, RingFull, WireConfig


def _ring(capacity=1 << 16, reclaim="local"):
    name, _ = wire_mod.segment_names("t")
    return Ring.create(name, capacity, reclaim=reclaim)


def _shm_names():
    try:
        return {f for f in os.listdir("/dev/shm")
                if f.startswith("cfxw-")}
    except FileNotFoundError:  # non-Linux: rely on close() not raising
        return set()


def _echo_submit_many(batch):
    futs = []
    for _sid, b, _q in batch:
        f = Future()
        f.set_result(np.asarray(b).copy())
        futs.append(f)
    return futs


# --------------------------------------------------------------------------- #
# ring protocol
# --------------------------------------------------------------------------- #


def test_segment_names_fit_posix_name_limit():
    """macOS caps POSIX shm names at 31 bytes (PSHMNAMLEN) INCLUDING
    the leading '/' the stdlib prepends — a long host id must trim,
    not make Ring.create fail, and the random token keeps two starts
    of the same host distinct."""
    rq, rp = wire_mod.segment_names("host-" + "x" * 60)
    assert max(len(rq), len(rp)) <= 30
    assert rq != rp
    assert wire_mod.segment_names("h")[0] != \
        wire_mod.segment_names("h")[0]


def test_ring_roundtrip_bitwise():
    """stage -> read is bitwise for every dtype/shape the fabric
    ships, both as a copy and as a zero-copy view."""
    r = _ring()
    try:
        for arr in [np.arange(24, dtype=np.float32),
                    np.random.default_rng(0).standard_normal(
                        (32, 256, 1)).astype(np.float32),
                    np.arange(6, dtype=np.float64).reshape(2, 3),
                    np.array([], dtype=np.float32),
                    np.arange(7, dtype=np.int32)]:
            d = r.stage(arr)
            got = r.read(d, copy=True)
            assert got.dtype == arr.dtype and got.shape == arr.shape
            assert np.array_equal(got, arr)
            view = r.read(d, copy=False)
            assert np.array_equal(view, arr)
            del view
            r.free(d)
    finally:
        r.close()


def test_ring_wrap_and_reclaim():
    """Thousands of stage/free cycles through a small ring: the
    monotonic cursors wrap past capacity many times and every read
    stays bitwise — the skip-tail wrap never aliases a live record."""
    r = _ring(capacity=4096)
    try:
        live = []
        rng = np.random.default_rng(1)
        for i in range(2000):
            arr = rng.standard_normal(
                rng.integers(1, 80)).astype(np.float32)
            d = r.stage(arr)
            live.append((d, arr))
            if len(live) > 3:
                d0, a0 = live.pop(0)
                assert np.array_equal(r.read(d0, copy=True), a0)
                r.free(d0)
        assert r._w > 10 * r.capacity  # really wrapped
    finally:
        r.close()


def test_ring_out_of_order_free():
    """The floor only advances over the contiguous freed prefix, so
    freeing out of order never reclaims bytes a live record holds."""
    r = _ring(capacity=4096)
    try:
        a = [np.full(64, i, np.float32) for i in range(3)]
        d = [r.stage(x) for x in a]
        r.free(d[1])             # hole: floor must NOT move
        assert r.used_bytes() == r._w
        r.free(d[0])             # prefix closes: floor jumps over both
        assert r.used_bytes() == r._w - d[2]["c"]
        assert np.array_equal(r.read(d[2], copy=True), a[2])
        r.free(d[2])
        assert r.used_bytes() == 0
    finally:
        r.close()


def test_ring_full_is_structured():
    """An allocation past capacity raises RingFull (needed/capacity
    attached) and the ring stays usable after frees."""
    r = _ring(capacity=4096)
    try:
        big = np.zeros(700, np.float32)  # ~2.8KB + overhead
        d0 = r.stage(big)
        with pytest.raises(RingFull) as ei:
            r.stage(big)
        assert ei.value.needed > 0 and ei.value.capacity == 4096
        r.free(d0)
        r.free(r.stage(big))     # reclaimed space admits again
    finally:
        r.close()


def test_ring_stale_generation_detected():
    """A recycled slot under a live descriptor (the post-SIGKILL /
    wrapped-writer hazard) fails the header generation check."""
    r = _ring()
    try:
        d = r.stage(np.arange(8, dtype=np.float32))
        stale = dict(d, g=d["g"] + 7)
        with pytest.raises(WireCorrupt) as ei:
            r.read(stale, copy=True)
        assert ei.value.kind == "stale_generation"
    finally:
        r.close()


def test_ring_torn_footer_detected():
    """A record whose footer never landed (writer died mid-copy) is a
    torn segment — typed, instant, never a garbage payload."""
    r = _ring()
    try:
        d = r.stage(np.arange(8, dtype=np.float32))
        # scribble over the footer exactly as an unfinished write would
        import struct
        struct.pack_into("<II", r._shm.buf,
                         64 + d["o"] + 24 + d["n"], 0, 0)
        with pytest.raises(WireCorrupt) as ei:
            r.read(d, copy=True)
        assert ei.value.kind == "torn_segment"
    finally:
        r.close()


def test_ring_overrun_descriptor_detected():
    """A descriptor naming bytes outside the segment is refused
    before any memory is touched."""
    r = _ring(capacity=4096)
    try:
        d = r.stage(np.arange(8, dtype=np.float32))
        with pytest.raises(WireCorrupt) as ei:
            r.read(dict(d, o=4096 - 8), copy=True)
        assert ei.value.kind == "overrun"
        with pytest.raises(WireCorrupt):
            r.read(dict(d, n=1 << 30), copy=True)
    finally:
        r.close()


def test_ring_close_unlinks_segment():
    """close() removes the /dev/shm name (leak audit), and a creator
    close beats any number of attacher closes."""
    before = _shm_names()
    r = _ring()
    made = _shm_names() - before
    att = Ring.attach(r.name) if made else None
    if att is not None:
        att.close()          # attacher: detach only, name survives
        assert made <= _shm_names()
    r.close()
    assert not (_shm_names() & made)
    r.close()                # idempotent


def test_wire_config_validates():
    with pytest.raises(ValueError):
        WireConfig(ring_bytes=16)
    with pytest.raises(ValueError):
        WireConfig(max_payload_frac=0.0)
    cfg = WireConfig(ring_bytes=1 << 20, batch_window_s=0.002)
    assert WireConfig.from_json(cfg.to_json()) == cfg


# --------------------------------------------------------------------------- #
# loopback endpoints (real segments, in-process control plane)
# --------------------------------------------------------------------------- #


def test_loopback_echo_parity_and_batching():
    """A burst of echoes round-trips bitwise through the rings, and
    the opportunistic pump coalesces them into fewer control frames
    than requests."""
    w = InProcWire(_echo_submit_many)
    try:
        rng = np.random.default_rng(2)
        payloads = [rng.standard_normal((32, 256, 1)).astype(np.float32)
                    for _ in range(40)]
        futs = [w.solve(None, p, op="echo") for p in payloads]
        for f, p in zip(futs, payloads):
            assert np.array_equal(f.result(timeout=30), p)
        st = w.stats()
        assert st["staged"] == 40 and st["replies"] == 40
        assert st["frames"] <= 40  # batching never inflates the frame count
        assert st["req_used"] == 0 and st["rep_used"] == 0  # all reclaimed
    finally:
        w.close()


def _port_session(n=24, v=8, seed=3):
    import torch

    from conflux_tpu_torch import serve

    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, n)) / np.sqrt(n)
         + 2.0 * np.eye(n)).astype(np.float32)
    plan = serve.FactorPlan.create((n, n), torch.float32, v=v)
    return A, plan.factor(A, device="cpu"), rng


def test_loopback_engine_parity_bitwise():
    """Solves routed through the shm wire into a port ServeEngine are
    bitwise the direct submits and the session's own solves: the
    zero-copy staging does not change a bit."""
    from conflux_tpu_torch.engine import ServeEngine

    n = 24
    _A, s, rng = _port_session(n)
    with ServeEngine(max_batch_delay=0.0, device="cpu") as eng:
        w = InProcWire(lambda batch: eng.submit_many(
            [(s, b, q) for _sid, b, q in batch]))
        try:
            for width in (1, 3, 1):
                b = rng.standard_normal((n, width)).astype(np.float32)
                ref = np.asarray(eng.submit(s, b).result(timeout=30))
                got = w.solve("sid", b).result(timeout=30)
                assert np.array_equal(got, ref)
                assert np.array_equal(got, np.asarray(s.solve(b)))
        finally:
            w.close()


def test_loopback_large_payload_inline_fallback():
    """A reply too large for its configured ring share rides the
    control frame inline (pickle fallback) — still bitwise, counted."""
    cfg = WireConfig(ring_bytes=1 << 20, max_payload_frac=0.01)
    w = InProcWire(_echo_submit_many, config=cfg)
    try:
        big = np.random.default_rng(4).standard_normal(
            (64, 256)).astype(np.float32)  # 64KB > 1% of 1MB
        assert np.array_equal(w.solve(None, big, op="echo")
                              .result(timeout=30), big)
    finally:
        w.close()


def test_reply_ring_full_falls_back_inline():
    """The worker's reply pump never blocks on ring space: past the
    bounded wait it ships the value inline and counts the fallback."""
    cfg = WireConfig(ring_bytes=4096, reply_wait_s=0.02)
    frames = []
    rq, rp = _ring(capacity=4096), _ring(capacity=4096,
                                         reclaim="shared")
    srv = wire_mod.WireServer(rq, rp, frames.append, config=cfg)
    try:
        # stuff the reply ring with minimum-size records until even
        # the smallest allocation refuses, with no reader draining
        while True:
            try:
                rp.stage(np.zeros(1, np.float32))
            except RingFull:
                break
        srv.reply(7, value=np.arange(16, dtype=np.float32))
        t0 = time.perf_counter()
        while not frames and time.perf_counter() - t0 < 10:
            time.sleep(0.005)
        (item,) = frames[0]["items"]
        assert item["id"] == 7 and "d" not in item
        assert np.array_equal(item["v"],
                              np.arange(16, dtype=np.float32))
        assert srv.stats()["fallbacks"] == 1
    finally:
        srv.close()
        rq.close()
        rp.close()


# --------------------------------------------------------------------------- #
# fault sites + structural death
# --------------------------------------------------------------------------- #


def test_fault_site_ring_full_backpressure():
    """The ring_full fault site forces the structured refusal path:
    submit raises RingFull with a retry hint; traffic then resumes."""
    plan = FaultPlan([FaultSpec(site="ring_full", kind="crash",
                                count=1)])
    w = InProcWire(_echo_submit_many, fault_plan=plan)
    try:
        b = np.arange(8, dtype=np.float32)
        with pytest.raises(RingFull) as ei:
            w.solve(None, b, op="echo")
        assert ei.value.retry_after > 0.0
        assert np.array_equal(w.solve(None, b, op="echo")
                              .result(timeout=30), b)
        assert plan.injected.get(("ring_full", "crash")) == 1
    finally:
        w.close()


@pytest.mark.parametrize("site,kind", [
    ("torn_segment", "torn_segment"),
    ("stale_generation", "stale_generation"),
])
def test_fault_site_corruption_is_instant_structural_death(site, kind):
    """torn_segment / stale_generation fire on the CLIENT's decode of
    a reply record: every pending future fails with WireCorrupt NOW
    (kind-tagged), the wire refuses new traffic — never a hang, never
    a wrong answer."""
    plan = FaultPlan([FaultSpec(site=site, kind="crash", count=1)])
    w = InProcWire(_echo_submit_many, fault_plan=plan)
    try:
        fut = w.solve(None, np.arange(8, dtype=np.float32), op="echo")
        with pytest.raises(WireCorrupt) as ei:
            fut.result(timeout=30)
        assert ei.value.kind == kind
        with pytest.raises(ConnectionError):
            w.solve(None, np.arange(8, dtype=np.float32), op="echo")
    finally:
        w.close()


def test_server_side_corrupt_request_fails_per_item():
    """A corrupt REQUEST record fails its own item with a structured
    error reply; frame-mates still answer bitwise."""
    # server reads requests with the installed plan absent; inject by
    # corrupting the staged record directly instead
    w = InProcWire(_echo_submit_many)
    try:
        good = np.arange(8, dtype=np.float32)
        # craft a frame by hand: one good item, one stale descriptor
        d_ok = w.client._req.stage(good)
        d_bad = dict(w.client._req.stage(good), g=999999)
        fut_ok: Future = Future()
        fut_bad: Future = Future()
        with w._lock:
            w._pending[101] = fut_ok
            w._pending[102] = fut_bad
            w.client._by_mid[101] = d_ok
            w.client._by_mid[102] = d_bad
        w.server.handle(
            {"op": "solve_many",
             "items": [{"id": 101, "sid": None, "d": d_ok,
                        "op": "echo"},
                       {"id": 102, "sid": None, "d": d_bad,
                        "op": "echo"}]},
            _echo_submit_many)
        assert np.array_equal(fut_ok.result(timeout=30), good)
        with pytest.raises(RuntimeError, match="WireCorrupt"):
            fut_bad.result(timeout=30)
    finally:
        w.close()


def test_loopback_no_shm_leaks_after_close():
    before = _shm_names()
    w = InProcWire(_echo_submit_many)
    w.solve(None, np.arange(4, dtype=np.float32),
            op="echo").result(timeout=30)
    assert len(_shm_names() - before) == 2
    w.close()
    assert not (_shm_names() - before)

# --------------------------------------------------------------------------- #
# batched submission (submit_many / max_frame_items)
# --------------------------------------------------------------------------- #


def test_submit_many_one_lock_burst_bitwise():
    """A whole burst staged through `submit_many` round-trips bitwise
    and counts as staged; the control plane needs far fewer frames
    than requests."""
    w = InProcWire(_echo_submit_many)
    try:
        rng = np.random.default_rng(11)
        payloads = [rng.standard_normal((8, 32)).astype(np.float32)
                    for _ in range(24)]
        futs, entries = [], []
        with w._lock:
            for p in payloads:
                mid = w._next
                w._next += 1
                f: Future = Future()
                w._pending[mid] = f
                futs.append(f)
                entries.append((mid, None, p, None, "echo"))
        assert w.client.submit_many(entries) == len(entries)
        for f, p in zip(futs, payloads):
            assert np.array_equal(f.result(timeout=30), p)
        st = w.stats()
        assert st["staged"] == 24 and st["replies"] == 24
        assert st["frames"] < 24
    finally:
        w.close()


def test_submit_many_short_count_on_ring_full():
    """A burst bigger than the ring stages a PREFIX and returns the
    short count — RingFull raises only when nothing fit, with the
    measured-drain retry hint attached."""
    frames: list = []
    rq = _ring(capacity=4096)
    rp = _ring(capacity=4096, reclaim="shared")
    c = wire_mod.WireClient(rq, rp, frames.append, host_id="t")
    try:
        arr = np.zeros(256, np.float32)  # 1112B record span
        entries = [(i, None, arr, None, "solve") for i in range(6)]
        n = c.submit_many(entries)
        assert 0 < n < 6               # the ring filled mid-burst
        with pytest.raises(RingFull) as ei:
            c.submit_many(entries[n:])  # nothing can fit now
        assert ei.value.retry_after > 0.0
        assert c.stats()["staged"] == n
    finally:
        c.close()
        rq.close()
        rp.close()


def test_max_frame_items_slices_bursts():
    """Frames never exceed `max_frame_items`: a one-lock burst is
    sliced into consecutive frames so the peer starts draining the
    first slice while the rest is still queued (the anti-lockstep
    contract)."""
    frames: list = []
    rq = _ring(capacity=1 << 20)
    rp = _ring(capacity=1 << 20, reclaim="shared")
    c = wire_mod.WireClient(rq, rp, frames.append, host_id="t",
                            config=WireConfig(max_frame_items=4))
    try:
        arr = np.zeros(16, np.float32)
        assert c.submit_many(
            [(i, None, arr, None, "solve") for i in range(18)]) == 18
        deadline = time.time() + 10.0
        while (sum(len(f["items"]) for f in frames) < 18
               and time.time() < deadline):
            time.sleep(0.005)
        sizes = [len(f["items"]) for f in frames]
        assert sum(sizes) == 18
        assert max(sizes) <= 4         # the cap held on every frame
        assert len(frames) >= 5        # 18 items can't fit in 4 frames
    finally:
        c.close()
        rq.close()
        rp.close()


def test_processhost_echo_many_pickle_path_order_and_cleanup():
    """`echo_many` on the pickle wire sends the whole burst under one
    lock, preserves order, and leaves no pending entries behind."""
    from conflux_tpu_torch import fabric

    class _EchoNow:
        """A Connection stand-in that answers echoes synchronously
        (send is called under _send_lock, so resolve inline)."""

        def __init__(self, host):
            self.host = host

        def send(self, msg):
            fut = self.host._pending.pop(msg["id"])
            fut.set_result({"id": msg["id"], "ok": True,
                            "value": msg["b"] * 2.0})

        def close(self):
            pass

    h = fabric.ProcessHost("he", "unused-he", wire="pickle")
    h._conn = _EchoNow(h)
    payloads = [np.full((4,), float(i), np.float32) for i in range(7)]
    out = h.echo_many(payloads, timeout=5.0)
    assert len(out) == 7
    for i, x in enumerate(out):
        assert np.array_equal(x, payloads[i] * 2.0)
    assert h._pending == {}


# --------------------------------------------------------------------------- #
# parity with the JAX package's wire
# --------------------------------------------------------------------------- #


def _staging_script(seed=21):
    """A fixed sequence of payloads and frees that wraps a 4 KiB ring."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(60):
        kind = i % 5
        if kind == 0:
            arr = rng.standard_normal(rng.integers(1, 90)).astype(np.float32)
        elif kind == 1:
            arr = rng.standard_normal((3, rng.integers(1, 9))).astype(np.float64)
        elif kind == 2:
            arr = np.arange(rng.integers(0, 40), dtype=np.int32)
        elif kind == 3:
            arr = rng.standard_normal((2, 4, 1)).astype(np.float32)
        else:
            arr = np.array([], dtype=np.float32)
        steps.append(arr)
    return steps


def _drive(ring, steps):
    descs, live = [], []
    for arr in steps:
        d = ring.stage(arr)
        descs.append(d)
        live.append(d)
        if len(live) > 3:
            if ring._reclaim == "shared":  # the reader's FIFO release
                ring.release(live.pop(0))
            else:                          # out of order, local floor
                ring.free(live.pop(1 if len(live) % 2 else 0))
    return descs


@pytest.mark.parametrize("reclaim", ["local", "shared"])
def test_ring_bytes_equal_across_packages(reclaim):
    """The same `stage`/`free` sequence on fresh rings of equal capacity
    leaves equal segment bytes and equal descriptors in both packages:
    header and footer generation tags, the cursor words, the wrap."""
    steps = _staging_script()
    name_p, _ = wire_mod.segment_names("pp")
    name_r, _ = ref_wire.segment_names("pr")
    rp = Ring.create(name_p, 4096, reclaim=reclaim)
    rr = ref_wire.Ring.create(name_r, 4096, reclaim=reclaim)
    try:
        dp, dr = _drive(rp, steps), _drive(rr, steps)
        assert dp == dr
        assert rp._w > rp.capacity  # the sequence really wrapped
        assert bytes(rp._shm.buf) == bytes(rr._shm.buf)
    finally:
        rp.close()
        rr.close()


def test_ring_records_read_across_packages():
    """Each package's `Ring.attach` reads the other's records bitwise,
    and the integrity checks trip alike on a stale descriptor."""
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal((8, 3)).astype(np.float32),
            np.arange(5, dtype=np.float64), np.arange(7, dtype=np.int32)]
    for make, attach in ((Ring.create, ref_wire.Ring.attach),
                         (ref_wire.Ring.create, Ring.attach)):
        name, _ = wire_mod.segment_names("x")
        w = make(name, 1 << 14)
        r = attach(name)
        try:
            for a in arrs:
                d = w.stage(a)
                got = r.read(d, copy=True)
                assert got.dtype == a.dtype and np.array_equal(got, a)
                with pytest.raises(Exception) as ei:
                    r.read(dict(d, g=d["g"] + 1), copy=True)
                assert type(ei.value).__name__ == "WireCorrupt"
                assert ei.value.kind == "stale_generation"
        finally:
            r.close()
            w.close()


def test_loopback_agrees_with_the_jax_loopback():
    """The port's loopback through a port engine and the JAX package's
    loopback through a JAX engine answer the same seeded system within
    1e-5 (f32)."""
    import jax.numpy as jnp

    from conflux_tpu import serve as ref_serve
    from conflux_tpu.engine import ServeEngine as RefEngine
    from conflux_tpu_torch.engine import ServeEngine

    n = 24
    A, s, rng = _port_session(n, seed=7)
    bs = [rng.standard_normal((n, w)).astype(np.float32) for w in (1, 2, 1)]
    ref_serve.clear_plans()
    rs = ref_serve.FactorPlan.create((n, n), jnp.float32, v=8).factor(
        jnp.asarray(A))
    with ServeEngine(max_batch_delay=0.0, device="cpu") as eng, \
            RefEngine(max_batch_delay=0.0) as reng:
        w = InProcWire(lambda batch: eng.submit_many(
            [(s, b, q) for _sid, b, q in batch]))
        rw = ref_wire.InProcWire(lambda batch: reng.submit_many(
            [(rs, b, q) for _sid, b, q in batch]))
        try:
            for b in bs:
                got = w.solve("sid", b).result(timeout=30)
                ref = np.asarray(rw.solve("sid", b).result(timeout=30))
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
                assert np.abs(A @ got - b).max() < 1e-4
        finally:
            w.close()
            rw.close()
