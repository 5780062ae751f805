"""`scripts/torch_soak.py` on the CPU: the configuration soak against the
JAX package's `scripts/soak.py` and its grid programs, and one trial of
each serving mode the port's soak shares with the reference.

- the sampler: the port's `_rand_config` draws the reference's
  configuration, key for key (dtypes by name), for seeds 0-499, so a seed
  names the same trial in both packages;
- pinned configuration trials: complex64 on grids of several ranks, the
  resume legs at Pz = 1 (bitwise) and Pz = 2, Cholesky on 2x2x2, QR in
  complex64, a bfloat16 draw and a butterfly draw;
- one seed per core: `factor_config`'s gathered factor against the JAX
  program's on the same configuration and input, float64, allclose 1e-10
  at Pz = 1 and 1e-9 at Pz > 1 (the tolerances of
  `tests/test_torch_lu_distributed.py`), with the reference's own trial
  passing on that seed;
- mutations: a perturbed factor or answer fails its trial;
- `--replay` prints the reference's label.
"""

import importlib.util
import os

import numpy as np
import pytest
from torch_registry_guard import registry_guard  # noqa: F401

import jax
import jax.numpy as jnp

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _load(name: str, file: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    mod = _load("torch_soak_under_test", "torch_soak.py")
    mod.ENGINE["device"] = "cpu"
    return mod


@pytest.fixture(scope="module")
def ref():
    return _load("jax_soak_under_test", "soak.py")


def _name(d) -> str:
    return d if isinstance(d, str) else np.dtype(d).name


def test_sampler_draws_the_reference_configurations(port, ref):
    for seed in range(500):
        want = ref._rand_config(np.random.default_rng(seed))
        got = port._rand_config(np.random.default_rng(seed))
        for key, val in want.items():
            if key == "dtype":
                assert _name(got[key]) == _name(val), seed
            else:
                assert got[key] == val, (seed, key)
        assert set(got) - set(want) == ({"backend", "panel_algo"} if want["core"] == "lu"
                                        else {"backend"})
        assert got["backend"] in port.BACKENDS
        if _name(port.config(seed)["dtype"]) not in ("float32", "bfloat16"):
            assert got["backend"] == "xla"  # K1 takes float32 and bfloat16 only


# seed -> (core, grid, dtype, resume) as the sampler draws it
PINNED = {
    1: ("lu", (3, 2, 1), "complex64", False),
    14: ("lu", (2, 2, 1), "float64", True),
    73: ("lu", (4, 1, 2), "float64", True),
    38: ("cholesky", (2, 2, 2), "float32", True),
    28: ("qr", (3, 1, 2), "complex64", True),
    4: ("qr", (6, 1, 1), "bfloat16", True),
    29: ("lu", (2, 4, 1), "bfloat16", False),  # election butterfly
    # update "block": the resume's first half ran its last trailing update
    # as one GEMM where the one-shot run cuts the next panel's column slab
    # out as a piece of its own, and a complex64 GEMM in two column pieces
    # is not bitwise the whole
    68: ("lu", (3, 2, 1), "complex64", True),
}


@pytest.mark.parametrize("seed", sorted(PINNED))
def test_configuration_trial(port, seed):
    cfg = port.config(seed)
    assert (cfg["core"], cfg["grid"], _name(cfg["dtype"]), cfg["resume"]) == PINNED[seed]
    if seed == 29:
        assert cfg["election"] == "butterfly"
    ok, msg = port.run_trial(seed)
    assert ok, msg


def _jax_outputs(cfg: dict, seed: int, out: dict) -> dict:
    """The JAX program's outputs on `cfg` and on the port's input `out["A"]`."""
    from conflux_tpu.geometry import CholeskyGeometry, Grid3, LUGeometry
    from conflux_tpu.ops import blas as jblas
    from conflux_tpu.parallel.mesh import make_mesh

    grid = Grid3(*cfg["grid"])
    mesh = make_mesh(grid, devices=jax.devices()[: grid.P])
    N, v = cfg["N"], cfg["v"]
    if cfg["core"] == "lu":
        from conflux_tpu.lu.distributed import lu_factor_distributed

        geom = LUGeometry.create(N, N, v, grid)
        prev = jblas.get_panel_algo()
        jblas.set_panel_algo(cfg["panel_algo"])
        try:
            LU, perm = lu_factor_distributed(
                jnp.asarray(geom.scatter(out["A"][:N, :N])), geom, mesh,
                election=cfg["election"], tree=cfg["tree"], update=cfg["update"],
                segs=cfg["segs"], lookahead=cfg["lookahead"], panel_chunk=cfg["panel_chunk"])
        finally:
            jblas.set_panel_algo(prev)
        return {"LU": geom.gather(np.asarray(LU)), "perm": np.asarray(perm)}
    if cfg["core"] == "cholesky":
        from conflux_tpu.cholesky.distributed import cholesky_factor_distributed

        geom = CholeskyGeometry.create(N, v, grid)
        L = cholesky_factor_distributed(jnp.asarray(geom.scatter(out["A"])), geom, mesh,
                                        segs=cfg["segs"], lookahead=cfg["lookahead"])
        return {"L": np.tril(geom.gather(np.asarray(L)))}
    from conflux_tpu.qr.distributed import qr_factor_distributed, r_geometry

    geom = LUGeometry.create(N, N, v, grid)
    if geom.M < geom.N:
        geom = LUGeometry.create(geom.N, N, v, grid)
    Q, R = qr_factor_distributed(jnp.asarray(geom.scatter(out["A"][: geom.Mbase, :N])), geom,
                                 mesh, csegs=cfg["csegs"], lookahead=cfg["lookahead"])
    return {"Q": geom.gather(np.asarray(Q)), "R": r_geometry(geom).gather(np.asarray(R))}


# one float64 seed per core, each on a grid of several ranks
PARITY = {0: "lu", 11: "cholesky", 6: "qr"}


@pytest.mark.parametrize("seed", sorted(PARITY))
def test_factor_config_matches_the_jax_program(port, ref, seed):
    cfg = port.config(seed)
    assert cfg["core"] == PARITY[seed] and cfg["dtype"] is np.float64
    assert cfg["grid"] != (1, 1, 1)
    ok, msg = ref.run_trial(seed)
    assert ok, msg
    out = port.factor_config(cfg, seed)
    want = _jax_outputs(cfg, seed, out)
    tol = 1e-10 if cfg["grid"][2] == 1 else 1e-9
    if cfg["core"] == "lu":
        np.testing.assert_array_equal(out["perm"], want["perm"])
        np.testing.assert_allclose(out["LU"], want["LU"], rtol=tol, atol=tol)
    elif cfg["core"] == "cholesky":
        np.testing.assert_allclose(np.tril(out["L"]), want["L"], rtol=tol, atol=tol)
    else:
        np.testing.assert_allclose(out["Q"], want["Q"], rtol=tol, atol=tol)
        n = want["R"].shape[1]
        np.testing.assert_allclose(np.triu(out["R"][:n]), np.triu(want["R"][:n]),
                                   rtol=tol, atol=tol)


SERVING = ("precision", "qos", "adaptive", "gang", "fleet", "mesh", "scale")


@pytest.mark.parametrize("mode", SERVING)
def test_serving_mode_trial(port, mode):
    ok, msg = port.TRIALS[mode](0)
    assert ok, msg


def test_a_perturbed_factor_fails_its_trial(port, monkeypatch):
    seed = 0  # LU, float64: a bar of 1e-9 sqrt(N) 10
    ok, msg = port.run_trial(seed)
    assert ok, msg
    honest = port.factor_config

    def perturbed(cfg, s, device=None):
        out = honest(cfg, s, device)
        out["LU"][3, 5] += 1e-3
        return out

    monkeypatch.setattr(port, "factor_config", perturbed)
    ok, msg = port.run_trial(seed)
    assert not ok and "residual" in msg, msg


class _Off:
    """A future whose answer is 5% off: above every tier's bar (2e-2)."""

    def __init__(self, fut):
        self._fut = fut

    def done(self):
        return self._fut.done()

    def result(self, timeout=None):
        return np.asarray(self._fut.result(timeout)) * 1.05


def test_a_perturbed_answer_fails_its_precision_trial(port, monkeypatch):
    from conflux_tpu_torch import engine

    honest = engine.ServeEngine.submit
    monkeypatch.setattr(engine.ServeEngine, "submit",
                        lambda self, *a, **k: _Off(honest(self, *a, **k)))
    ok, msg = port.run_precision_trial(0)
    assert not ok and "off oracle" in msg, msg


def test_replay_prints_the_reference_label(port, ref, capsys):
    cfg = ref._rand_config(np.random.default_rng(1))
    label = "seed=1 " + " ".join(f"{k}={v}" for k, v in cfg.items())
    assert port.main(["--replay", "1", "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert label + " " in out and ": ok residual=" in out, out
