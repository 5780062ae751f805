"""Throughput serving: plan cache + device-resident solve sessions (the port
of the LU serving core of `conflux_tpu/serve.py`).

A serving workload ("many users, many right-hand sides") wants to build the
programs once per shape, factor once per matrix, and answer each request
with only the O(N^2) substitution against factors that stay on the card:

- :class:`FactorPlan` is the program cache for one configuration, keyed by
  :class:`PlanKey` (the JAX package's fields). Its programs are Python
  callables memoized per power-of-two bucket; `trace_counts` counts their
  builds, one per bucket, as the JAX package counts traces.
- :class:`SolveSession` holds the factors. ``plan.factor(A)`` factors once;
  ``session.solve(b)`` runs the substitution only, and
  ``session.solve_checked(b)`` adds the Freivalds health verdict.

    plan = FactorPlan.create((32, 256, 256), torch.float32, v=128)
    session = plan.factor(A)          # O(N^3), once, on the K4 kernel
    x = session.solve(b)              # O(N^2), one K3 launch

    spd = FactorPlan.create((32, 256, 256), torch.float32, v=128, kind="chol")
    x = spd.factor(S).solve(b)        # K5 once, then one K3 launch a round

A plan on backend "kernel" with float32 or float64 systems and
``factor_dtype == dtype`` factors through a batched factor kernel
(`ops.batched_factor`): LU plans through K4, SPD plans (``kind="chol"``,
or the legacy ``spd=True``) through the batched Cholesky K5, the
counterparts of a JAX plan made with ``backend="pallas"``. Every other
plan (bfloat16 storage, ``factor_dtype != dtype`` such as the HPL-MxP
``factor_dtype=bfloat16`` plan, ``backend="xla"``) factors through the
batched blocked factor (`lu.single.lu_factor_blocked`,
`cholesky.single.cholesky_blocked` on the stacked batch), the
counterpart of the JAX package's vmapped `_one_factor`: on "kernel" its
panels run on K2 and its trailing updates on K1. ``plan.factor`` rides
bucket 1 of the factor lane's stacked program, so a session it opens and
one opened by a coalesced bucket come from the same program (bit for bit
on the kernel route). Blocked plans (the default) solve
through the batched blocked triangular-solve kernel (K3,
`hopper_kernels.btrsm_pair`): the batched form of the block loop the JAX
programs vmap, a whole round (the row permutation, forward, back, and
for checked solves the probe stats) in one launch; an SPD plan's back
solve reads L^T in place.

Ported: LU and Cholesky plans (single and batched; float32, float64,
bfloat16 storage and any factor dtype; backends "kernel" and "xla";
substitution blocked|trsm|inv, `refine` sweeps), checked solves and the
factor lane's coalesced programs. Not ported yet, each raising
NotImplementedError: QR plans, mesh plans, the precision ladder, Woodbury
update/refactor, gang stacks, tier residency and bucket retirement, device
moves, the plan codec and the engine.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch

from conflux_tpu_torch import profiler
from conflux_tpu_torch.batched import cholesky_solve_batched, unstack_tree
from conflux_tpu_torch.device import resolve_device
from conflux_tpu_torch.lu.single import from_numpy
from conflux_tpu_torch.ops import blas, hopper_kernels
from conflux_tpu_torch.ops.batched_trsm import diag_block_inverses
from conflux_tpu_torch.solvers import lu_solve
from conflux_tpu_torch.update import (
    DriftPolicy,
    health_spot_check,
    health_verdict_from_stats,
    probe_row,
    probe_vector,
    rank_bucket,
)


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Identity of a serving pipeline: the plan cache's key (the JAX
    package's fields)."""

    shape: tuple          # (B, N, N) batched or (N, N) single
    dtype: str            # storage dtype of A
    factor_dtype: str     # dtype the factorization runs in
    v: int                # tile size
    refine: int           # classic-IR sweeps fused into the solve program
    kind: str             # factorization family: 'lu' | 'chol' ('qr' to port)
    substitution: str     # 'trsm' | 'inv' | 'blocked' ('auto' -> 'blocked')
    precision: Any        # matmul precision: 'highest' (IEEE f32, no TF32)
    backend: str          # kernel backend
    panel_algo: str       # LU panel election algo
    mesh_key: Any         # batch-mesh identity (None: one device)


PLAN_KINDS = ("lu", "chol", "qr")

_PLANS: dict[PlanKey, "FactorPlan"] = {}
_PLANS_LOCK = threading.Lock()


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


def _unported(what: str):
    """A method of the JAX surface that this slice does not port: it
    raises NotImplementedError naming `what`."""
    def method(self, *args, **kwargs):
        raise _not_ported(what)

    method.__doc__ = f"Not ported yet: {what}."
    return method


class _CompileOnce:
    """Serialize the FIRST call of a built program; later calls bypass the
    lock. Two concurrent first callers of a cold bucket run its set-up
    once."""

    __slots__ = ("fn", "_lock", "_warm")

    def __init__(self, fn):
        self.fn = fn
        self._lock = threading.Lock()
        self._warm = False

    def __call__(self, *args):
        if self._warm:
            return self.fn(*args)
        with self._lock:
            out = self.fn(*args)
            self._warm = True
        return out

    @property
    def warm(self) -> bool:
        """True once the first call completed."""
        return self._warm


def clear_plans() -> None:
    """Drop every cached plan."""
    with _PLANS_LOCK:
        _PLANS.clear()


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return from_numpy(np.asarray(x), device)


def _round_operand(T: torch.Tensor, cdtype: torch.dtype) -> torch.Tensor:
    """A factor as K3 reads it in a solve round: a bfloat16 factor with
    float32 inverses as it is stored, anything else in `cdtype`."""
    if T.dtype == torch.bfloat16 and cdtype == torch.float32:
        return T
    return T.to(cdtype)


def _take_rows(r: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """r[..., perm, :] per system: (..., N, k) rows by (..., N) indices."""
    return torch.gather(r, -2, perm[..., None].expand(r.shape))


class FactorPlan:
    """A reusable factor -> solve pipeline for one configuration.

    Construct through :meth:`create` (the cache). Programs are built at
    first use, one per bucket, and counted in :attr:`trace_counts`.
    """

    def __init__(self, key: PlanKey):
        self.key = key
        shape = key.shape
        if key.kind not in PLAN_KINDS:
            raise ValueError(f"unknown plan kind {key.kind!r} — expected one "
                             f"of {PLAN_KINDS}")
        if key.kind == "qr":
            raise _not_ported("kind='qr' plans (QR least squares)")
        if key.mesh_key is not None:
            raise _not_ported("mesh plans")
        if len(shape) not in (2, 3) or shape[-1] != shape[-2]:
            raise ValueError(f"plan needs square systems, got {shape}")
        self.batched = len(shape) == 3
        self.B = shape[0] if self.batched else None
        self.N = shape[-1]
        self.M = shape[-2]
        if self.N % key.v:
            raise ValueError(f"N={self.N} not a multiple of v={key.v}; pre-pad "
                             "with an identity extension")
        if not self._kernel_factor:
            # the blocked factor's routes, refused here rather than at the
            # first factor: K1 takes float32 and bfloat16, K2 float32
            fd = _torch_dtype(key.factor_dtype)
            blas.check_gemm_route(key.backend, fd)
            if key.kind == "lu":
                blas._resolve_panel_algo(blas.compute_dtype(fd), self.N, key.v,
                                         key.panel_algo)
        self.trace_counts = {"factor": 0, "solve": 0}
        # concurrent first callers fill the memoized program caches
        # double-checked under this lock
        self._compile_lock = threading.Lock()
        self._solve_cache: dict[Any, Any] = {}
        self._factor_cache: dict[tuple, Any] = {}
        # the blocked engine's checked programs, apart from _solve_cache
        # as in the JAX package
        self._trsm_cache: dict[tuple, Any] = {}
        self._probe_w_dev: dict[torch.device, torch.Tensor] = {}

    def _memo(self, cache: dict, key, build):
        """Double-checked get-or-build of a program cache entry, wrapped in
        :class:`_CompileOnce`."""
        fn = cache.get(key)
        if fn is None:
            with self._compile_lock:
                fn = cache.get(key)
                if fn is None:
                    fn = _CompileOnce(build())
                    cache[key] = fn
        return fn

    def _bump(self, name: str) -> None:
        """Build-time counter, one per program and bucket: keys appear
        lazily, as in the JAX package."""
        self.trace_counts[name] = self.trace_counts.get(name, 0) + 1

    # ------------------------------------------------------------------ #
    # cache
    # ------------------------------------------------------------------ #

    @classmethod
    def create(cls, shape, dtype, *, v: int = 256, factor_dtype=None,
               refine: int = 0, kind: str | None = None, spd: bool = False,
               mesh=None, substitution: str = "auto", precision=None,
               backend: str | None = None) -> "FactorPlan":
        """Get-or-build the plan for a traffic shape: (B, N, N) batched or
        (N, N) single, `dtype` the request dtype. `substitution` picks the
        per-request engine: 'blocked' (what 'auto' resolves to)
        substitutes through diagonal-block inverses computed at factor
        time, 'trsm' runs the classic triangular solves, 'inv' inverts the
        full triangular factors at factor time. `refine` fuses classic
        iterative-refinement sweeps into the solve programs."""
        if kind is None:
            kind = "chol" if spd else "lu"
        elif spd and kind != "chol":
            raise ValueError(f"kind={kind!r} contradicts spd=True (the legacy "
                             "spelling of kind='chol') — pass one or the other")
        if mesh is not None:
            raise _not_ported("mesh plans")
        if precision not in (None, "highest"):
            raise _not_ported(f"matmul precision {precision!r} (the port "
                              "runs IEEE float32, 'highest')")
        if substitution == "auto":
            substitution = "blocked"
        if substitution not in ("trsm", "inv", "blocked"):
            raise ValueError(f"unknown substitution {substitution!r} "
                             "(auto|trsm|inv|blocked)")
        backend = blas.check_backend(
            blas.get_backend() if backend is None else backend)
        dname = _dtype_name(dtype)
        key = PlanKey(
            shape=tuple(int(s) for s in shape), dtype=dname,
            factor_dtype=dname if factor_dtype is None else _dtype_name(factor_dtype),
            v=int(v), refine=int(refine), kind=kind, substitution=substitution,
            precision="highest", backend=backend,
            panel_algo=blas.get_panel_algo(), mesh_key=None)
        with _PLANS_LOCK:
            plan = _PLANS.get(key)
            if plan is None:
                plan = cls(key)
                _PLANS[key] = plan
        return plan

    bucket_ready = _unported("bucket_ready (bucket lifecycle)")
    release_buckets = _unported("release_buckets (bucket lifecycle)")
    spec = _unported("the plan codec (plan_spec / plan_from_spec)")

    # ------------------------------------------------------------------ #
    # solve programs
    # ------------------------------------------------------------------ #

    @staticmethod
    def _pair(T, Dl, Du, r, perm=None, wA=None):
        """A blocked solve round of every system of a stack at once, one
        K3 launch (`hopper_kernels.btrsm_pair`): leading axes fold into its
        batch. Du None: the SPD back solve through T^T and Dl^T. Returns x,
        or (x, xsum, wAx) with the probe row wA."""
        n, k = r.shape[-2:]
        lead = r.shape[:-2]

        def fold(x, tail):
            return None if x is None else x.reshape((-1,) + x.shape[x.dim() - tail:])

        out = hopper_kernels.btrsm_pair(
            fold(T, 2), fold(Dl, 3), fold(Du, 3), r.reshape(-1, n, k),
            perm=fold(perm, 1), trans_back=Du is None, wA=fold(wA, 1))
        if wA is None:
            return out.reshape(r.shape)
        x, xsum, wAx = out
        return x.reshape(r.shape), xsum.reshape(lead), wAx.reshape(lead)

    def _blocked_round(self, factors, r, wA=None):
        """A blocked plan's solve round on its factors, (LU, Dl, Du, perm)
        or, SPD, (L, Dl): :meth:`_pair`. A bfloat16 factor goes to K3 as it
        is stored (its bfloat16 instance reads it, no cast per round)."""
        if self._spd:
            L, Dl = factors
            return self._pair(_round_operand(L, Dl.dtype), Dl, None, r.to(Dl.dtype), None, wA)
        LU, Dl, Du, perm = factors
        return self._pair(_round_operand(LU, Dl.dtype), Dl, Du, r.to(Dl.dtype), perm, wA)

    @property
    def _spd(self) -> bool:
        return self.key.kind == "chol"

    def _base_corr(self, factors):
        """The base substitution r -> A0^{-1} r through the resident
        factors. Batch-generic: factors and r share their leading axes (a
        plan's batch, a factor bucket's stack), the port's counterpart of
        the JAX package's vmap."""
        k = self.key
        if self._spd:
            return self._spd_corr(factors)
        if k.substitution == "blocked":
            return lambda r: self._blocked_round(factors, r)
        if k.substitution == "inv":
            Li, Ui, perm = factors

            def corr(r):
                y = torch.matmul(Li, _take_rows(r.to(Li.dtype), perm))
                return torch.matmul(Ui, y)
            return corr
        LU, perm = factors

        def corr(r):
            n, w = r.shape[-2:]
            LUf, pf = LU.reshape(-1, n, n), perm.reshape(-1, n)
            rf = r.reshape(-1, n, w)
            return torch.stack([lu_solve(LUf[i], pf[i], rf[i])
                                for i in range(rf.shape[0])]).reshape(r.shape)
        return corr

    def _spd_corr(self, factors):
        """:meth:`_base_corr` of an SPD plan: forward through L, back
        through L^T. Blocked plans run both in one K3 launch, the back solve
        reading L and the diagonal-block inverses Dl transposed."""
        k = self.key
        if k.substitution == "blocked":
            return lambda r: self._blocked_round(factors, r)
        if k.substitution == "inv":
            Li = factors[0]

            def corr(r):
                return torch.matmul(Li.mT, torch.matmul(Li, r.to(Li.dtype)))
            return corr
        L = factors[0]

        def corr(r):
            n, w = r.shape[-2:]
            return cholesky_solve_batched(L.reshape(-1, n, n),
                                          r.reshape(-1, n, w)).reshape(r.shape)
        return corr

    def _one_solve(self, factors, A, b2, sweeps=None):
        """Substitution + the plan's IR sweeps. `A` is only consumed when
        the sweep count > 0 (the residual matvec)."""
        k = self.key
        corr = self._base_corr(factors)
        cdtype = blas.compute_dtype(_torch_dtype(k.dtype))
        x = corr(b2).to(cdtype)
        for _ in range(k.refine if sweeps is None else sweeps):
            r = b2.to(cdtype) - torch.matmul(A.to(cdtype), x)
            x = x + corr(r).to(cdtype)
        return x

    @staticmethod
    def _check_bucket(what: str, n: int) -> None:
        if n & (n - 1) or n < 1:
            raise AssertionError(f"{what} takes power-of-two buckets, got {n}")

    def _solve_fn(self, nrhs: int):
        """The substitution program for one RHS-width bucket: sessions pad
        a request's width up to the next power of two and slice back
        (columns are independent through every step)."""
        self._check_bucket("_solve_fn", nrhs)

        def build():
            self._bump("solve")
            return self._one_solve

        return self._memo(self._solve_cache, nrhs, build)

    # ------------------------------------------------------------------ #
    # stacked (cold-start) factor programs: the factor lane
    # ------------------------------------------------------------------ #

    @property
    def _kernel_factor(self) -> bool:
        """True when this plan factors through a batched factor kernel (K4
        for LU, K5 for Cholesky), the counterpart of the JAX
        `_pallas_factor` gate: the "kernel" backend, no mesh, LU or
        Cholesky, and float32 or float64 with `dtype == factor_dtype` (so
        the kernel's probe row reads the operand `probe_row` would). Other
        plans factor through :meth:`_blocked_factor_core`."""
        k = self.key
        return (k.backend == "kernel" and k.mesh_key is None
                and k.kind in ("lu", "chol") and k.dtype == k.factor_dtype
                and k.factor_dtype in ("float32", "float64"))

    def _kernel_factor_core(self, Ast, probe: bool = False):
        """First half of the stacked factor: fold the stack (batched plans
        fold (bb, B) into one kernel batch) and launch K4 or K5. Returns
        (LU, perm[, wA]) or (L[, wA])."""
        shp = Ast.shape
        A2 = Ast.reshape((shp[0] * shp[1],) + shp[2:]) if self.batched else Ast
        w = self._probe_w_on(Ast.device) if probe else None
        if self._spd:
            out = blas.batched_cholesky_factor(A2, probe_w=w, backend=self.key.backend)
            return out if probe else (out,)
        return blas.batched_lu_factor(A2, probe_w=w, backend=self.key.backend)

    def _blocked_factor_core(self, Ast, probe: bool = False):
        """First half of the stacked factor of a plan outside the kernel
        gate: fold the stack (batched plans fold (bb, B) into one batch),
        cast it to the factor dtype and run the batched blocked factor on
        the plan's backend and panel algo, the counterpart of the JAX
        package's vmapped `_one_factor`; with `probe`, the probe rows
        wA = w^T A off the stack in the plan's dtype, as the JAX
        `_stacked_factor_body` computes them beside the factor. Returns
        (LU, perm[, wA]) or (L[, wA])."""
        from conflux_tpu_torch.cholesky.single import cholesky_blocked
        from conflux_tpu_torch.lu.single import lu_factor_blocked

        k = self.key
        A2 = Ast.reshape((-1,) + tuple(Ast.shape[-2:]))
        Af = A2.to(_torch_dtype(k.factor_dtype))
        if self._spd:
            core = (cholesky_blocked(Af, k.v, backend=k.backend),)
        else:
            core = lu_factor_blocked(Af, k.v, backend=k.backend, panel_algo=k.panel_algo)
        if not probe:
            return core
        return (*core, probe_row(self._probe_w_on(Ast.device), A2))

    def _factor_core(self, Ast, probe: bool = False):
        """The stacked factor's first half on this plan's route."""
        if self._kernel_factor:
            return self._kernel_factor_core(Ast, probe)
        return self._blocked_factor_core(Ast, probe)

    def _factor_epilogue(self, core, probe: bool = False):
        """Second half: the substitution epilogue on the factor's output
        (per-slot diagonal-block inverses for 'blocked', full triangular
        inverses for 'inv') and the (bb, B) unflatten of batched plans.
        Every op is per slot, so the kernel's per-slot bits survive into
        the session factors."""
        k = self.key
        cdtype = blas.compute_dtype(_torch_dtype(k.factor_dtype))
        if self._spd:
            L = core[0]
            if k.substitution == "blocked":
                F = (L, diag_block_inverses(L.to(cdtype), lower=True))
            elif k.substitution == "inv":
                # one library call per slot, as for LU plans below
                Lc = L.to(cdtype)
                eye = torch.eye(self.N, dtype=cdtype, device=L.device)
                F = (torch.stack([torch.linalg.solve_triangular(t, eye, upper=False)
                                  for t in Lc]),)
            else:
                F = (L,)
        else:
            LU, perm = core[0], core[1]
            LUc = LU.to(cdtype)
            if k.substitution == "trsm":
                F = (LU, perm)
            elif k.substitution == "blocked":
                F = (LU, diag_block_inverses(LUc, lower=True, unit_diagonal=True),
                     diag_block_inverses(LUc, lower=False), perm)
            else:
                # one library call per slot: on the card a batched call
                # changes algorithm with the batch size (looped TRSMs up to
                # 8 slots, batched above), and with it a slot's bits
                eye = torch.eye(self.N, dtype=cdtype, device=LU.device)
                F = (torch.stack([torch.linalg.solve_triangular(
                        t, eye, upper=False, unitriangular=True) for t in LUc]),
                     torch.stack([torch.linalg.solve_triangular(t, eye, upper=True)
                                  for t in LUc]),
                     perm)

        def unflat(x):
            if not self.batched:
                return x
            return x.reshape((x.shape[0] // self.B, self.B) + x.shape[1:])

        F = tuple(unflat(x) for x in F)
        if not probe:
            return F
        return F, unflat(core[-1])

    def _stacked_factor_fn(self, bb: int):
        """The factor lane's coalesced program: `bb` systems of this plan
        stacked on a new leading axis, (bb,) + key.shape, factored in one
        call (a K4 or K5 launch, or the batched blocked factor) at
        power-of-two batch buckets. On the kernel route each slot's
        factors are bitwise invariant to the bucket and to the pad
        contents; :meth:`factor` itself rides this program at bucket 1."""
        self._check_bucket("_stacked_factor_fn", bb)

        def build():
            self._bump("factor")

            def run(Ast):
                return self._factor_epilogue(self._factor_core(Ast))
            return run

        return self._memo(self._factor_cache, ("factor", bb), build)

    def _factor_health_fn(self, bb: int):
        """Checked coalesced program: factor the stack and produce each
        slot's health evidence in the same call, (bb,)+shape A ->
        (factors, wA, verdict (2, bb)). wA[i] = w^T A_i comes out of the K4
        or K5 launch (beside the blocked factor elsewhere); the verdict solves A_i x = w through the fresh factors
        and projects the residual through wA, so slot i's verdict depends
        only on slot i. Blocked plans without sweeps take the stats from the
        back substitution (:meth:`_blocked_probe_body`)."""
        self._check_bucket("_factor_health_fn", bb)

        def build():
            self._bump("factor_health")
            fused = self._fused_probe
            dtype = _torch_dtype(self.key.dtype)

            def check(F, wA, Ast):
                w = self._probe_w_on(Ast.device)
                w2 = w.to(dtype)[:, None].expand(F[0].shape[:-2] + (self.N, 1))
                if fused:
                    _x, xsum, wAx = self._blocked_probe_body(F, wA, w2)
                    cdtype = wAx.dtype
                    fin_acc = xsum.sum(-1) if self.batched else xsum
                    ax = wAx
                else:
                    x = self._one_solve(F, Ast, w2)
                    cdtype = x.dtype
                    fin_acc = x.sum(dim=tuple(range(1, x.dim())))
                    ax = (wA.to(cdtype) * x[..., 0]).sum(-1)
                finite = torch.isfinite(fin_acc)
                wc = w.to(cdtype)
                num = torch.abs((wc * wc).sum() - ax)
                den = torch.sqrt((wc.abs() ** 2).sum()) + torch.finfo(cdtype).tiny
                res = num / den
                if self.batched:
                    res = res.amax(-1)
                return torch.stack([finite.to(torch.float32),
                                    res.to(torch.float32)])

            def run(Ast):
                F, wA = self._factor_epilogue(
                    self._factor_core(Ast, probe=True), probe=True)
                return F, wA, check(F, wA, Ast)
            return run

        return self._memo(self._factor_cache, ("factor_health", bb), build)

    def _factor_once(self, A):
        """Factor ONE system (or one (B, N, N) batch) through the bucket-1
        slot of the stacked factor program, so every session carries
        factors of the same program family as the coalesced lane."""
        F = self._stacked_factor_fn(1)(A[None])
        return unstack_tree(F, 1)[0]

    # ------------------------------------------------------------------ #
    # checked (health-guarded) solve programs
    # ------------------------------------------------------------------ #

    @property
    def probe_w(self) -> torch.Tensor:
        """The plan's fixed Rademacher probe w (`update.probe_vector`, the
        JAX package's bits), as a host tensor."""
        return torch.from_numpy(probe_vector(self.N))

    def _probe_w_on(self, device) -> torch.Tensor:
        device = torch.device(device)
        w = self._probe_w_dev.get(device)
        if w is None:
            w = self._probe_w_dev.setdefault(device, self.probe_w.to(device))
        return w

    def _probe_fn(self):
        """The wA = w^T A0 program: the once-per-base half of the
        projected-residual check."""
        def build():
            return lambda A0: probe_row(self._probe_w_on(A0.device), A0)

        return self._memo(self._solve_cache, ("probe",), build)

    def _checked(self, inner):
        """Wrap a (factors, A0, b2) solve body into the checked shape
        (factors, A0, wA, b2) -> (x, (2,) verdict)."""
        def f(factors, A0, wA, b2):
            x = inner(factors, A0, b2)
            return x, health_spot_check(self._probe_w_on(b2.device), wA, x, b2)

        return f

    @property
    def _fused_probe(self) -> bool:
        """True when checked programs take the verdict's stats from the
        blocked back substitution: blocked plans without IR sweeps (a sweep
        re-reads x, so only the refine-free shape has a final back solve
        to take them from)."""
        return self.key.substitution == "blocked" and not self.key.refine

    def _blocked_probe_body(self, factors, wA, b2):
        """Blocked solve plus the probe stats: (x, xsum, wAx) with
        xsum = sum(x) per system (the finite accumulator) and
        wAx = wA . x[:, 0], accumulated per block of the back solve in the
        same K3 launch, as the JAX package accumulates them in its block
        loop."""
        cdtype = blas.compute_dtype(_torch_dtype(self.key.dtype))
        x, xsum, wAx = self._blocked_round(factors, b2, wA)
        return x.to(cdtype), xsum, wAx

    def _solve_health_fn(self, nrhs: int):
        """The checked substitution program per RHS bucket, what
        `SolveSession.solve_checked` runs: (factors, A0, wA, b2) ->
        (x, verdict)."""
        self._check_bucket("_solve_health_fn", nrhs)
        if self._fused_probe:
            def build():
                self._bump("health")

                def f(factors, A0, wA, b2):
                    x, xsum, wAx = self._blocked_probe_body(factors, wA, b2)
                    w = self._probe_w_on(b2.device)
                    return x, health_verdict_from_stats(w, xsum, wAx, b2)
                return f

            return self._memo(self._trsm_cache, ("health", nrhs), build)

        def build_checked():
            self._bump("health")
            return self._checked(self._one_solve)

        return self._memo(self._solve_cache, ("health", nrhs), build_checked)

    # ------------------------------------------------------------------ #
    # serving surface
    # ------------------------------------------------------------------ #

    def _check_A(self, A):
        if tuple(A.shape) != self.key.shape:
            raise ValueError(f"A shape {tuple(A.shape)} does not match the "
                             f"plan's {self.key.shape}")
        if A.dtype != _torch_dtype(self.key.dtype):
            raise ValueError(f"A dtype {A.dtype} does not match the plan's "
                             f"{self.key.dtype}")

    def factor(self, A, *, policy: DriftPolicy | None = None, device=None,
               precision: str | None = None) -> "SolveSession":
        """Factor A and open a session on its device-resident factors.

        A (numpy or tensor) is put on `device`: the card unless the caller
        passes device="cpu" (no card and no "cpu" raises). The session
        keeps A itself when the plan refines (the residual matvec) and as
        the base of its probe row. `precision=` (the precision ladder) is
        not ported yet."""
        if precision is not None:
            raise _not_ported("the precision ladder (factor(precision=...))")
        dev = resolve_device(device)
        A = _as_tensor(A, dev)
        self._check_A(A)
        with profiler.region("serve.factor"):
            factors = self._factor_once(A)
        keep_A = A if self.key.refine else None
        return SolveSession(self, factors, keep_A, A, policy, device=dev)


class SolveSession:
    """Device-resident factors + the plan's substitution programs.

    `solves` and `factorizations` count what this session ran: solve-only
    traffic keeps `factorizations == 1`.
    """

    def __init__(self, plan: FactorPlan, factors, A, A_base=None,
                 policy: DriftPolicy | None = None, *, device=None):
        self.plan = plan
        self.device = device
        # every read of the resident state happens under this lock
        self._lock = threading.RLock()
        self._factors = factors    # guarded-by: _lock
        self._A = A                # guarded-by: _lock
        self._A0 = A if A_base is None else A_base  # guarded-by: _lock
        self.policy = DriftPolicy() if policy is None else policy
        # wA = w^T A0, computed on the first checked solve
        self._probe = None         # guarded-by: _lock
        self.factorizations = 1    # guarded-by: _lock
        self.solves = 0            # guarded-by: _lock

    @property
    def factors(self):
        """The device-resident factors. LU plans: (LU, Dl, Du, perm) for
        'blocked', (LU, perm) for 'trsm', (Li, Ui, perm) for 'inv'. SPD
        plans: (L, Dl) for 'blocked', (L,) for 'trsm', (Li,) for 'inv'."""
        with self._lock:
            return self._factors

    @property
    def nbytes(self) -> int:
        """Device-resident footprint in bytes: factors + base matrix + the
        cached probe row, each buffer counted once (`_A` aliases `_A0`
        whenever the plan keeps it)."""
        with self._lock:
            seen: dict[int, int] = {}
            for leaf in (*self._factors, self._A, self._A0, self._probe):
                if leaf is not None:
                    seen[id(leaf)] = leaf.numel() * leaf.element_size()
            return sum(seen.values())

    update = _unported("the Woodbury drift update (SolveSession.update)")
    refactor = _unported("SolveSession.refactor")
    to_device = _unported("SolveSession.to_device")

    def _rhs(self, b):
        plan = self.plan
        b = _as_tensor(b, self.device)
        if plan.batched:
            want = (plan.B, plan.N)
            if b.dim() == 2:
                if tuple(b.shape) != want:
                    raise ValueError(f"rhs {tuple(b.shape)}, session needs {want}")
                return b[:, :, None], True
            if b.dim() != 3 or tuple(b.shape[:2]) != want:
                raise ValueError(f"rhs {tuple(b.shape)}, session needs {want} "
                                 "(+ rhs axis)")
            return b, False
        if b.dim() == 1:
            if b.shape[0] != plan.M:
                raise ValueError(f"rhs {tuple(b.shape)}, session needs ({plan.M},)")
            return b[:, None], True
        if b.dim() != 2 or b.shape[0] != plan.M:
            raise ValueError(f"rhs {tuple(b.shape)}, session needs ({plan.M}, k)")
        return b, False

    def _rhs_bucketed(self, b):
        b2, squeeze = self._rhs(b)
        nrhs = b2.shape[-1]
        nb = rank_bucket(nrhs)
        if nb != nrhs:
            b2 = torch.nn.functional.pad(b2, (0, nb - nrhs))
        return b2, nb, nrhs, squeeze

    def solve(self, b, *, precision=None):  # hot-path
        """Solve against the resident factors: the substitution plus the
        plan's `refine` sweeps. b is (N,)/(N, k) for single plans,
        (B, N)/(B, N, k) for batched ones; x comes back in b's shape.
        Widths are padded up to power-of-two buckets and sliced back."""
        if precision is not None:
            raise _not_ported("the precision ladder (solve(precision=...))")
        plan = self.plan
        b2, nb, nrhs, squeeze = self._rhs_bucketed(b)
        with self._lock:
            with profiler.region("serve.solve"):
                x = plan._solve_fn(nb)(self._factors, self._A, b2)
            self.solves += 1
        if nb != nrhs:
            x = x[..., :nrhs]
        return x[..., 0] if squeeze else x

    def _probe_row(self):
        """The session's cached probe row wA = w^T A0 (device-resident,
        once per base)."""
        with self._lock:
            if self._probe is None:
                self._probe = self.plan._probe_fn()(self._A0)
            return self._probe

    def solve_checked(self, b, *, precision=None):  # hot-path
        """`solve` plus the finite/projected-residual health verdict, in
        the same program: returns (x, verdict), verdict a (2,) float32
        tensor [finite_flag, residual] on the session's device (nothing
        here waits for the card)."""
        if precision is not None:
            raise _not_ported("the precision ladder (solve_checked(precision=...))")
        plan = self.plan
        b2, nb, nrhs, squeeze = self._rhs_bucketed(b)
        with self._lock:
            wA = self._probe_row()
            with profiler.region("serve.solve"):
                x, verdict = plan._solve_health_fn(nb)(
                    self._factors, self._A0, wA, b2)
            self.solves += 1
        if nb != nrhs:
            x = x[..., :nrhs]
        if squeeze:
            x = x[..., 0]
        return x, verdict


def session_from_numpy(plan: FactorPlan, factors, A, device=None) -> SolveSession:
    """Open a port session on factors made elsewhere, for example the
    factor pytree of a JAX `SolveSession` as numpy arrays, in the layout
    of :attr:`SolveSession.factors`: (LU, Dl, Du, perm) for a blocked LU
    plan, (LU, perm) for 'trsm', (Li, Ui, perm) for 'inv'; (L, Dl), (L,)
    and (Li,) for an SPD plan. A is the matrix they factor (the probe
    row's base, and the refinement sweeps' matvec). The counterpart of
    `lu.single.state_from_numpy`."""
    spd = plan._spd
    want = ({"blocked": 2, "trsm": 1, "inv": 1} if spd else
            {"blocked": 4, "trsm": 2, "inv": 3})[plan.key.substitution]
    if len(factors) != want:
        raise ValueError(f"a {plan.key.substitution!r} {plan.key.kind} plan's "
                         f"factors have {want} leaves, got {len(factors)}")
    dev = resolve_device(device)
    # an LU plan's last leaf is its permutation
    F = tuple(from_numpy(np.asarray(f).astype(np.int64) if not spd and i == want - 1
                         else np.asarray(f), dev)
              for i, f in enumerate(factors))
    A = _as_tensor(A, dev)
    plan._check_A(A)
    return SolveSession(plan, F, A if plan.key.refine else None, A, device=dev)
