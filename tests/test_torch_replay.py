"""`scripts/torch_replay.py` on the CPU against the JAX package's
`scripts/replay.py` (loaded as `tests/test_scale.py` loads it):

- leg (a): `control_plane_leg(fleet=300, pairs=4, victims_per_pick=6,
  touches_per_round=200, seed=3)` has 0 mismatches between the heap and
  sort picks, and every pick's victim set, taken as stub indices, equals
  the reference's on the same seed, pick for pick;
- `make_schedule(np.random.default_rng(5), 50, 2.0, 10.0, storms=2,
  storm_frac=0.1)` equals the reference's event for event;
- one small macro leg (fleet 32, 2 hosts, cap 4, N=48, a 1.5 s trace)
  through the port's leg-(b) functions on CPU engines: the resident
  high-water never above the cap, the census exact, no unstructured
  failure, every untouched session within 1e-4 of its numpy float64
  oracle, the delta checkpoint writing only the dirtied records;
- the chaos leg at fleet 24 (a host killed mid-traffic, K=2 replicas,
  background delta checkpoints): no violation, 0 sessions lost;
- `main` raises without a card unless given `--platform cpu`.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
N = 48


def _load(name: str, file: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _load("torch_replay_under_test", "torch_replay.py")


@pytest.fixture(scope="module")
def ref():
    return _load("replay_mod", "replay.py")


def _recording(mod, monkeypatch) -> list:
    """Patch `mod`'s stub and ResidentSet so every victim pick is recorded
    as the set of stub indices (creation order) it chose."""
    made, picks = [], []

    class Stub(mod._StubSession):
        def __init__(self, nbytes):
            super().__init__(nbytes)
            made.append(self)

    class Recording(mod.ResidentSet):
        def _pick_victims(self, incoming_bytes, incoming_count):
            victims = super()._pick_victims(incoming_bytes, incoming_count)
            index = {id(s): i for i, s in enumerate(made)}
            picks.append(frozenset(index[id(s)] for s in victims))
            return victims

    monkeypatch.setattr(mod, "_StubSession", Stub)
    monkeypatch.setattr(mod, "ResidentSet", Recording)
    return picks


def test_control_plane_picks_the_reference_victims(port, ref, monkeypatch):
    kw = dict(fleet=300, pairs=4, victims_per_pick=6, touches_per_round=200, seed=3)
    got_picks, want_picks = _recording(port, monkeypatch), _recording(ref, monkeypatch)
    got = port.control_plane_leg(**kw)
    want = ref.control_plane_leg(**kw)
    assert got["victim_set_mismatches"] == 0 == want["victim_set_mismatches"]
    assert got["sort_us_per_victim_p50"] > 0 and got["heap_us_per_victim_p50"] > 0
    # 2 warm-up picks and 2 per pair, 6 victims each (evict_batch 1)
    assert len(got_picks) >= 2 + 2 * kw["pairs"]
    assert [p for p in got_picks if p] == [p for p in want_picks if p]
    assert all(len(p) == 6 for p in got_picks if p)


def test_schedule_is_the_reference_schedule(port, ref):
    got = port.make_schedule(np.random.default_rng(5), 50, 2.0, 10.0, storms=2,
                             storm_frac=0.1)
    want = ref.make_schedule(np.random.default_rng(5), 50, 2.0, 10.0, storms=2,
                             storm_frac=0.1)
    assert got == want
    assert {e[1] for e in got} == {"solve", "update"}


def test_small_macro_leg_holds_its_invariants(port, tmp_path):
    from conflux_tpu_torch import profiler, serve
    from conflux_tpu_torch import tier as tier_mod

    profiler.clear()
    tier_mod.clear_tier()
    fleet, cap = 32, 4
    rng = np.random.default_rng(0)
    plan = serve.FactorPlan.create((N, N), torch.float32, v=8)
    fab = port.build_fabric(str(tmp_path / "macro"), 2, cap, device="cpu")
    with fab:
        oracles = port.open_fleet(fab, plan, rng, fleet, N, oracle_every=1)
        port.adopt_and_warm(fab, N, warm=4)
        events = port.make_schedule(rng, fleet, 1.5, 20.0, storms=1, storm_frac=0.1)
        trace = port.run_trace(fab, events, N, workers=4, rng_seed=1)
        ckpt, dirty = port.checkpoint_contrast(fab, fleet, N, 0.1, 2)
        stale = trace["updated_sessions"] | dirty
        sampled = {i: a for i, a in oracles.items() if i not in stale}
        bad = port.residual_check(fab, sampled, N, 3, bound=1e-4)
        st = fab.stats()
        hws = [fab._hosts[h].core.eng.residency.stats()["resident_high_water"]
               for h in sorted(fab._hosts)]
    assert not trace["errors"], trace["errors"][:3]
    assert trace["requests"] > 0
    assert len(sampled) >= fleet // 2 and not bad, bad
    assert max(hws) <= cap and max(hws) > 0, hws
    assert st["lost_sessions"] == 0 and st["sessions"] == fleet
    assert st["admitted_sessions"] == st["sessions"] + st["lost_sessions"] \
        + st["closed_sessions"]
    assert ckpt["delta_records_written"] == ckpt["storm_dirty_sessions"] == len(dirty)
    assert ckpt["delta_records_carried"] == fleet - len(dirty)


def test_chaos_leg_loses_nothing(port, tmp_path):
    out = port.chaos_leg(str(tmp_path), 24, N, 5, device="cpu")
    assert out["violations"] == [], out["violations"]
    assert out["lost_sessions"] == 0 and out["recoveries"] >= 1
    c = out["census"]
    assert c["admitted_sessions"] == c["sessions"] + c["lost_sessions"] + c["closed_sessions"]
    assert out["oracle_sessions"] > 0 and out["oracle_failures"] == 0


def test_main_without_card_raises(port, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        port.main(["--smoke"])
