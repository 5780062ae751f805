"""Throughput serving: plan cache + device-resident solve sessions (the port
of the single-device serving core of `conflux_tpu/serve.py`).

A serving workload ("many users, many right-hand sides") wants to build the
programs once per shape, factor once per matrix, and answer each request
with only the O(N^2) substitution against factors that stay on the card:

- :class:`FactorPlan` is the program cache for one configuration, keyed by
  :class:`PlanKey` (the JAX package's fields). Its programs are Python
  callables memoized per power-of-two bucket; `trace_counts` counts their
  builds, one per bucket, under the names the JAX package counts traces
  by (`factor`, `solve`, `health`, `update`, `update_solve`, `refine`).
- :class:`SolveSession` holds the factors. ``plan.factor(A)`` factors once;
  ``session.solve(b)`` runs the substitution only, and
  ``session.solve_checked(b)`` adds the Freivalds health verdict.

    plan = FactorPlan.create((32, 256, 256), torch.float32, v=128)
    session = plan.factor(A)          # O(N^3), once, on the K4 kernel
    x = session.solve(b)              # O(N^2), one K3 launch
    session.update(U, V)              # rank-k drift A + U V^T: one K3 round
    x = session.solve(b)              # base factors + k x k correction
    xb = plan.factor(A, precision="bf16_ir").solve(b)  # bf16 factors + IR

    spd = FactorPlan.create((32, 256, 256), torch.float32, v=128, kind="chol")
    x = spd.factor(S).solve(b)        # K5 once, then one K3 launch a round
    ls = FactorPlan.create((4096, 256), torch.float32, kind="qr")
    x = ls.factor(T).solve(c)         # min ||T x - c||, library QR

A plan on backend "kernel" with float32 or float64 systems and
``factor_dtype == dtype`` factors through a batched factor kernel
(`ops.batched_factor`): LU plans through K4, SPD plans (``kind="chol"``,
or the legacy ``spd=True``) through the batched Cholesky K5, the
counterparts of a JAX plan made with ``backend="pallas"``. Every other
LU or SPD plan (bfloat16 storage, ``factor_dtype != dtype`` such as the
HPL-MxP ``factor_dtype=bfloat16`` plan, ``backend="xla"``) factors
through the batched blocked factor (`lu.single.lu_factor_blocked`,
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
solve reads L^T in place. ``kind="qr"`` plans serve min ||A x - b|| for a
single tall (M, N) system through the thin (Q, R) of
`qr.single.qr_factor_blocked`; like the JAX package's they run no kernel
(library QR, `solve_triangular` and products).

Drift: ``session.update(U, V)`` applies A <- A + U V^H through a
Sherman-Morrison-Woodbury correction (`update`): the capacitance is one
base substitution with the kb columns of U (one K3 round on a blocked
plan), and every later solve one more round plus O(N k) products. The
session's :class:`~update.DriftPolicy` pays one true refactorization
when the accumulated rank or the capacitance's condition stops paying.

Precision ladder: ``precision=`` on `factor`, `solve` and `solve_checked`
serves a tier of :data:`PRECISION_TIERS`: 'bf16_ir' factors in bfloat16
and always refines at least once against the session's base, 'f32' and
'f64' factor at that dtype; 'auto' starts at the session's sticky rung
and `resilience.escalate_precision` climbs it on an unhealthy verdict.
Routes by dtype: a tier factors through the plan's own route where that
route takes the tier's dtype (a kernel-route f32 plan's 'f32' tier is its
native K4 factor, 'bf16_ir' the batched blocked factor on K2 and K1); K1
and K2 have no float64 instance, so a kernel-route plan's 'f64' tier
factors on the JAX package's default library route (backend "xla",
panel algo "auto") and solves through K3's float64 instance.

Gang stacks: the serving engine (`engine.ServeEngine(stack_sessions=True)`)
answers requests against different sessions of one single-system plan in
one dispatch off a gang-resident stack of their factors (`gang`). The
stacked programs (`_stacked_solve_fn`, its checked form and the stacked
Woodbury forms) run a whole stack's round in one K3 launch on a blocked
plan; a slot's answer is bitwise invariant to the stack bucket and to
what the pad slots hold.

Ported: LU, Cholesky and QR plans (single and batched; float32, float64,
bfloat16 storage and any factor dtype; backends "kernel" and "xla";
substitution blocked|trsm|inv, `refine` sweeps), checked solves, the
factor lane's coalesced programs, Woodbury update/refactor with the drift
policy, refine_checked (the escalation ladder's rung 2), the precision
tiers, the stacked (gang) programs, the bucket lifecycle
(`bucket_ready`, `release_buckets` and the per-device warmth registry,
one set of warm buckets),
`SolveSession.to_device`, the plan codec (`plan_spec`,
`plan_from_spec`) and the residency hooks of tiered sessions (`tier`: a
spilled session faults back in under its lock on its next touch,
`_ensure_resident`). Not ported yet, each raising NotImplementedError: mesh
plans and matmul precision other than 'highest'.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any

import numpy as np
import torch

from conflux_tpu_torch import profiler, resilience
from conflux_tpu_torch.batched import cholesky_solve_batched, put_tree, unstack_tree
from conflux_tpu_torch.device import hand_to_default, resolve_device, same_device
from conflux_tpu_torch.lu.single import from_numpy
from conflux_tpu_torch.ops import blas, hopper_kernels
from conflux_tpu_torch.ops.batched_trsm import diag_block_inverses
from conflux_tpu_torch.solvers import lu_solve
from conflux_tpu_torch.update import (
    DriftPolicy,
    apply_update,
    capacitance,
    health_spot_check,
    health_spot_check_slots,
    health_verdict_from_stats,
    health_verdict_from_stats_slots,
    probe_lstsq,
    probe_row,
    probe_vector,
    rank_bucket,
    updated_matvec,
    woodbury_apply,
)


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Identity of a serving pipeline: the plan cache's key (the JAX
    package's fields)."""

    shape: tuple          # (B, N, N) batched, (N, N) single, or (M, N)
                          # tall (kind='qr' least squares, M >= N)
    dtype: str            # storage dtype of A
    factor_dtype: str     # dtype the factorization runs in
    v: int                # tile size
    refine: int           # classic-IR sweeps fused into the solve program
    kind: str             # factorization family: 'lu' | 'chol' | 'qr'
    substitution: str     # 'trsm' | 'inv' | 'blocked' ('auto' -> 'blocked';
                          # 'trsm' for kind='qr')
    precision: Any        # matmul precision: 'highest' (IEEE f32, no TF32)
    backend: str          # kernel backend
    panel_algo: str       # LU panel election algo
    mesh_key: Any         # batch-mesh identity (None: one device)

    @property
    def spd(self) -> bool:
        """The legacy boolean: True when the plan factors by Cholesky (the
        codec and the cache key speak `kind` only)."""
        return self.kind == "chol"


PLAN_KINDS = ("lu", "chol", "qr")

# the per-request precision ladder: each served tier names a factor dtype
# and the IR sweeps its solve programs fuse ('bf16_ir' always refines at
# least once). 'auto' requests start on the cheapest rung and the
# Freivalds verdict drives escalation up this tuple.
PRECISION_TIERS = ("bf16_ir", "f32", "f64")

_TIER_DTYPES = {"bf16_ir": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}


def check_precision_request(precision):
    """Validate a per-request ``precision=``: None (the plan's native
    path), a served tier name, or 'auto'. Returns the value; raises
    ValueError naming the offending value otherwise."""
    if precision is None or precision == "auto" or precision in PRECISION_TIERS:
        return precision
    raise ValueError(f"unknown precision {precision!r} — expected None, 'auto', or "
                     f"one of {PRECISION_TIERS}")


def next_precision_tier(tier: str):
    """The next rung up the ladder, or None at the top (escalation then
    falls through to the native `resilience.escalate` rungs)."""
    i = PRECISION_TIERS.index(tier)
    return PRECISION_TIERS[i + 1] if i + 1 < len(PRECISION_TIERS) else None

_PLANS: dict[PlanKey, "FactorPlan"] = {}
_PLANS_LOCK = threading.Lock()

_MESH_SLICE = ("mesh plans (the serving mesh lane, ROADMAP Slice 7 item 14, "
               "waits for torch.distributed)")


def _encode_precision(p):
    """JSON form of a plan key's matmul precision. The port runs IEEE
    float32 only, 'highest', which encodes as the string the JAX package
    writes for a string precision; anything else is refused here, while
    the record is still writable."""
    if p is None or isinstance(p, str):
        return p
    raise ValueError(f"plan precision {p!r} (type {type(p).__name__}) is not "
                     "codec-representable: use None or a string")


def _decode_precision(p):
    """Inverse of :func:`_encode_precision`, reading the JAX package's
    records too: its tagged enum pair ['precision', 'HIGHEST'] and the
    strings None and 'highest' all name the port's 'highest'. Another
    precision raises NotImplementedError (the port has no matmul precision
    but IEEE float32); a malformed payload raises ValueError naming it."""
    if isinstance(p, list):
        if len(p) == 2 and p[0] == "precision" and isinstance(p[1], str):
            p = p[1].lower()
        else:
            raise ValueError(f"malformed precision payload {p!r}: expected "
                             "['precision', <enum name>]")
    elif p is not None and not isinstance(p, str):
        raise ValueError(f"malformed precision payload {p!r} (type "
                         f"{type(p).__name__}): expected None, a string, or a "
                         "tagged enum pair")
    if p is None or p == "highest":
        return "highest"
    raise _not_ported(f"matmul precision {p!r} (the port runs IEEE float32, "
                      "'highest')")


def plan_spec(plan: "FactorPlan") -> dict:
    """JSON-serializable identity of a plan: the codec that a checkpoint
    or another process rebuilds the exact plan from
    (:func:`plan_from_spec`). The dict has the JAX package's keys, with the
    port's dtype names, backend names and panel algos."""
    k = plan.key
    if k.mesh_key is not None:
        raise _not_ported(_MESH_SLICE)
    return {"shape": list(k.shape), "dtype": k.dtype,
            "factor_dtype": k.factor_dtype, "v": k.v, "refine": k.refine,
            "kind": k.kind, "substitution": k.substitution,
            "precision": _encode_precision(k.precision),
            "backend": k.backend, "panel_algo": k.panel_algo}


def plan_from_spec(d: dict) -> "FactorPlan":
    """Rebuild the exact :class:`PlanKey` a :func:`plan_spec` dict names
    (the knobs it was built under included, not re-read from the process's
    registry) and get-or-build its plan: same key, same programs, same
    bits. Records written before plans had a `kind` spell it as the
    boolean 'spd' and decode here. A "mesh" sub-dict raises
    NotImplementedError naming the mesh slice."""
    if d.get("mesh") is not None:
        raise _not_ported(_MESH_SLICE)
    if "kind" in d:
        kind = str(d["kind"])
        if kind not in PLAN_KINDS:
            raise ValueError(f"plan spec names unknown kind {kind!r}: expected one "
                             f"of {PLAN_KINDS}")
    else:
        kind = "chol" if bool(d["spd"]) else "lu"
    backend = blas.check_backend(d["backend"])
    key = PlanKey(
        shape=tuple(int(s) for s in d["shape"]), dtype=str(d["dtype"]),
        factor_dtype=str(d["factor_dtype"]), v=int(d["v"]),
        refine=int(d["refine"]), kind=kind, substitution=str(d["substitution"]),
        precision=_decode_precision(d["precision"]), backend=backend,
        panel_algo=str(d["panel_algo"]), mesh_key=None)
    for name in (key.dtype, key.factor_dtype):
        if not isinstance(getattr(torch, name, None), torch.dtype):
            raise ValueError(f"plan spec names unknown dtype {name!r}")
    return FactorPlan.from_key(key)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


class _CompileOnce:
    """Serialize the FIRST call of a built program; later calls bypass the
    lock. Two concurrent first callers of a cold bucket run its set-up
    once; `on_first` runs once, after the first call completed."""

    __slots__ = ("fn", "_lock", "_warm", "_on_first")

    def __init__(self, fn, on_first=None):
        self.fn = fn
        self._lock = threading.Lock()
        self._warm = False
        self._on_first = on_first

    def __call__(self, *args):
        if self._warm:
            return self.fn(*args)
        with self._lock:
            out = self.fn(*args)
            if not self._warm:
                self._warm = True
                if self._on_first is not None:
                    self._on_first()
        return out

    @property
    def warm(self) -> bool:
        """True once the first call completed."""
        return self._warm


# program cache keys of the bucket lifecycle -> their family: a key's
# tail is the bucket, whose last entry is an RHS width (a batch size for
# the factor families); a bare int key is the plain solve program's width
_FAMILIES = {"health": "solve_health", "refine": "refine", "factor": "factor",
             "factor_health": "factor_health", "tier": "tier",
             "tier_health": "tier_health", "tier_factor": "tier_factor"}


def _bucket_family(key) -> tuple | None:
    """(family, bucket) of a program cache key; None for the probe and the
    Woodbury programs, which no bucket retires."""
    if isinstance(key, int):
        return "solve", (key,)
    fam = _FAMILIES.get(key[0])
    return None if fam is None else (fam, tuple(key[1:]))


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
        if key.mesh_key is not None:
            raise _not_ported("mesh plans")
        if len(shape) not in (2, 3):
            raise ValueError(f"plan shape {shape}: (B, N, N), (N, N) or (M, N)")
        self.batched = len(shape) == 3
        self.B = shape[0] if self.batched else None
        self.N = shape[-1]
        # the rhs row count: N for the square kinds, M >= N for kind='qr'
        self.M = shape[-2]
        if key.kind == "qr":
            if self.batched:
                raise ValueError(
                    "kind='qr' serves single tall-skinny systems — a batched plan "
                    f"shape {shape} has no least-squares semantics here (open one "
                    "session per system)")
            if self.M < self.N:
                raise ValueError(f"kind='qr' needs M >= N (min||Ax-b|| over a "
                                 f"tall-skinny A), got {shape}")
            if key.substitution != "trsm":
                raise ValueError("kind='qr' substitutes through R only "
                                 "(substitution='trsm'); 'blocked'/'inv' are the "
                                 "square kinds' engines")
        else:
            if shape[-1] != shape[-2]:
                raise ValueError(f"plan needs square systems, got {shape}")
            if self.N % key.v:
                raise ValueError(f"N={self.N} not a multiple of v={key.v}; pre-pad "
                                 "with an identity extension")
            if not self._kernel_factor:
                # the blocked factor's routes, refused here rather than at
                # the first factor: K1 takes float32 and bfloat16, K2 float32
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
        # the Woodbury programs, per rank bucket (and RHS bucket)
        self._update_cache: dict[tuple, Any] = {}
        # the blocked engine's checked programs, apart from _solve_cache
        # as in the JAX package
        self._trsm_cache: dict[tuple, Any] = {}
        self._probe_w_dev: dict[torch.device, torch.Tensor] = {}
        # the bucket lifecycle's one registry: (family, bucket, device key)
        # of every completed warm-up. An engine's warm-up dispatch records
        # its lane's device (`mark_device_warm`); a program's first
        # completed call, whoever made it, records device key None
        self._warm: set = set()  # guarded-by: _compile_lock

    def _memo(self, cache: dict, key, build):
        """Double-checked get-or-build of a program cache entry, wrapped in
        :class:`_CompileOnce`. Nothing is compiled here: a program is a
        Python callable over the kernels, which build once per process
        (`ops/_build.py`, `profiler.compile_count`)."""
        fn = cache.get(key)
        if fn is None:
            with self._compile_lock:
                fn = cache.get(key)
                if fn is None:
                    fam = _bucket_family(key)
                    fn = _CompileOnce(build(), None if fam is None else functools.partial(
                        self.mark_device_warm, fam[0], fam[1], None))
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
        (N, N) single, or (M, N) with M >= N for a tall least-squares plan
        (`kind='qr'`), `dtype` the request dtype. `substitution` picks the
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
            # QR substitutes through R alone; the square kinds take the
            # blocked engine
            substitution = "trsm" if kind == "qr" else "blocked"
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

    @classmethod
    def from_key(cls, key: PlanKey) -> "FactorPlan":
        """Get-or-build the plan of an exact :class:`PlanKey`: the restore
        path rebuilds the key as it was written rather than re-deriving it
        from the process's registry, so it lands on the same programs."""
        if not isinstance(key, PlanKey):
            raise TypeError(f"from_key takes a PlanKey, got {type(key).__name__}")
        with _PLANS_LOCK:
            plan = _PLANS.get(key)
            if plan is None:
                plan = cls(key)
                _PLANS[key] = plan
        return plan

    def spec(self) -> dict:
        """This plan's :func:`plan_spec` dict."""
        return plan_spec(self)

    @classmethod
    def from_spec(cls, d: dict) -> "FactorPlan":
        """Get-or-build the plan a :func:`plan_spec` dict names."""
        return plan_from_spec(d)

    # ------------------------------------------------------------------ #
    # bucket lifecycle
    # ------------------------------------------------------------------ #

    def bucket_ready(self, *, width: int | None = None,
                     factor_batch: int | None = None, stack=None,
                     checked: bool = False, precision: str | None = None) -> bool:
        """True when the named bucket is warm: its program completed a
        call (the JAX package's "traced") or an engine warmed it on a
        device. The gate a knob move waits for, so that no first use lands
        on the serving path. `width` names an RHS bucket, `factor_batch` a
        coalesced factor bucket, `stack` a (sessions, width) gang bucket,
        warm once an engine's `prewarm(stacks=)` warmed it (the stacked
        programs are shared callables, nothing is made per bucket);
        `checked` asks about the health-guarded program; `precision` about
        a served tier's program family (with `width` its solve program,
        with `factor_batch` its stacked factor program)."""
        sfx = "_health" if checked else ""
        asks = []
        if precision is not None:
            tier = check_precision_request(precision)
            if tier is None or tier == "auto":
                raise ValueError("bucket_ready(precision=) names a concrete tier "
                                 f"from {PRECISION_TIERS}, not {precision!r}")
            if stack is not None:
                raise ValueError("gang-stacked buckets have no per-tier program "
                                 "family (tier requests are a counted gang exclusion)")
            if width is not None:
                asks.append(("tier" + sfx, (tier, width)))
            if factor_batch is not None:
                asks.append(("tier_factor", (tier, factor_batch)))
        else:
            if width is not None:
                asks.append(("solve" + sfx, width))
            if factor_batch is not None:
                asks.append(("factor" + sfx, factor_batch))
            if stack is not None:
                asks.append(("stacked" + sfx, tuple(stack)))
        want = {self._warm_key(kind, bucket, None)[:2] for kind, bucket in asks}
        with self._compile_lock:
            have = {k[:2] for k in self._warm}
        return bool(want) and want <= have

    def release_buckets(self, widths=(), factor_batches=()) -> int:
        """Retire buckets, the reverse of prewarming: `widths` drops each
        RHS bucket's plain, checked, refine and tier solve programs;
        `factor_batches` the coalesced factor programs (plain, checked and
        per tier). The probe and Woodbury programs stay, and factor bucket
        1 is refused (`plan.factor` itself rides it). The buckets' warm
        records go too (stacked ones included), so a bucket that grows
        back is warmed again. Returns the number of program cache entries
        dropped. A released bucket is cold, not forbidden: traffic that
        touches it makes its program again (and `trace_counts` grow); a
        caller holding a program it fetched before keeps using it."""
        wbs = {int(w) for w in widths}
        fbs = {int(b) for b in factor_batches}
        if 1 in fbs:
            raise ValueError("factor bucket 1 is the plan.factor/refactor path "
                             "itself (FactorPlan._factor_once): it is not a "
                             "retirable coalescing bucket")

        def retired(family: str, bucket: tuple) -> bool:
            return bucket[-1] in (fbs if "factor" in family else wbs)

        dropped = 0
        with self._compile_lock:
            for cache in (self._solve_cache, self._trsm_cache, self._factor_cache):
                for key in [k for k in cache
                            if (fam := _bucket_family(k)) is not None and retired(*fam)]:
                    del cache[key]
                    dropped += 1
            self._warm = {k for k in self._warm if not retired(k[0], k[1])}
        return dropped

    @staticmethod
    def _warm_key(kind: str, bucket, devkey) -> tuple:
        # every bucket is stored as a tuple ((width,), (stack, width),
        # (stack, rank, width), (tier, width), ...); tier names stay strings
        b = bucket if isinstance(bucket, tuple) else (bucket,)
        return (kind, tuple(x if isinstance(x, str) else int(x) for x in b), devkey)

    def device_warm(self, kind: str, bucket, devkey) -> bool:
        """True when (kind, bucket) has completed a warm-up dispatch on the
        device `devkey` names (`engine._devkey`): the engine's per-lane
        prewarm dedupe. `bucket` is an int for the width and factor
        families and a tuple for the stacked and tier ones."""
        with self._compile_lock:
            return self._warm_key(kind, bucket, devkey) in self._warm

    def mark_device_warm(self, kind: str, bucket, devkey) -> None:
        """Record a completed (kind, bucket, device) warm-up; the engine
        calls it after the warming dispatch finished, so a prewarm that
        failed leaves no record."""
        with self._compile_lock:
            self._warm.add(self._warm_key(kind, bucket, devkey))

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
        if k.kind == "qr":
            return self._qr_corr(factors)
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

    @staticmethod
    def _qr_corr(factors):
        """:meth:`_base_corr` of a QR plan, the least-squares substitution:
        project the (M, k) right-hand side onto range(A) through Q^H, then
        one triangular solve through R, (M, k) -> (N, k); the refinement
        sweeps reuse it (the correction of the least-squares residual is
        the least-squares correction). Computes in the compute dtype
        (bfloat16 factors in float32)."""
        Q, R = factors
        cdtype = blas.compute_dtype(Q.dtype)
        Qc, Rc = Q.to(cdtype), R.to(cdtype)

        def corr(r):
            y = torch.matmul(Qc.mH, r.to(cdtype))
            return torch.linalg.solve_triangular(Rc, y, upper=True)
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
    # stacked (gang) solve programs: many sessions of one plan at once
    # ------------------------------------------------------------------ #

    def _check_stack_bucket(self, what: str, ns: int, nrhs: int) -> None:
        if self.batched:
            raise AssertionError(
                "stacked dispatch is for single-system plans: batched plans already "
                "amortize over their own batch axis")
        if ns & (ns - 1) or ns < 1 or nrhs & (nrhs - 1) or nrhs < 1:
            raise AssertionError(
                f"{what} takes power-of-two buckets, got ({ns}, {nrhs}): route "
                "requests through ServeEngine")

    def _stacked_solve_fn(self, ns: int, nrhs: int):
        """The engine's cross-session program: `ns` sessions of this
        single-system plan, their factors stacked on a new leading axis (a
        gang's resident stack, `gang.SessionGang`), answered in one
        dispatch: (F, A0, b) -> x with b (ns, N, nrhs), A0 None for a
        refine-free plan. On a blocked plan the round is one K3 launch
        over the stack (`_pair` folds the stack into the kernel's batch).
        Slots never interact, so a slot's answer is bitwise invariant to
        the stack bucket and to what the pad slots hold; on the card it is
        also bitwise the session's own solve (`chip_smoke.py` phase 27
        holds both). One callable serves every bucket: the buckets are
        checked, nothing is made per bucket."""
        self._check_stack_bucket("_stacked_solve_fn", ns, nrhs)
        return self._one_solve

    def _stacked_solve_health_fn(self, ns: int, nrhs: int):
        """The checked stacked program: (F, A0, wA, b) -> (x, (2, ns)
        verdict), the Freivalds verdict per slot, so a sick slot is named
        without re-dispatching its gang-mates (`resilience.evaluate_slots`).
        wA is the gang's stacked probe rows. A blocked plan without sweeps
        takes each slot's stats from the same K3 launch's back solve."""
        self._check_stack_bucket("_stacked_solve_health_fn", ns, nrhs)
        return self._stacked_solve_health

    def _stacked_solve_health(self, factors, A0, wA, b2):
        w = self._probe_w_on(b2.device)
        if self._fused_probe:
            x, xsum, wAx = self._blocked_probe_body(factors, wA, b2)
            return x, health_verdict_from_stats_slots(w, xsum, wAx, b2)
        x = self._one_solve(factors, A0, b2)
        return x, health_spot_check_slots(w, wA, x, b2)

    def _stacked_update_solve_fn(self, ns: int, kb: int, nrhs: int, sweeps: int):
        """The stacked Woodbury program: every slot rides the base
        substitution plus its kb-bucketed capacitance correction, clean
        slots with zero U, V (an exactly-zero correction), drifted ones
        with their `update.pad_update_state`-padded state:
        (F, A0, Up, Vp, Y, Cinv, b) -> x, A0 None when sweeps == 0. The
        base substitution is one K3 launch over the stack; the products
        around it are `torch.matmul` in IEEE float32, as the JAX package
        computes them outside any kernel."""
        self._check_stack_bucket("_stacked_update_solve_fn", ns, nrhs)
        return functools.partial(self._one_update_solve, sweeps)

    def _stacked_update_solve_health_fn(self, ns: int, kb: int, nrhs: int, sweeps: int):
        """The checked stacked Woodbury program: each slot's projected
        residual goes through its drifted matrix (w^T A1 = wA + (w^T Up)
        Vp^H, zero-padded columns inert), so a correction gone wrong trips
        its own slot's verdict only: (F, A0, Up, Vp, Y, Cinv, wA, b) ->
        (x, (2, ns))."""
        self._check_stack_bucket("_stacked_update_solve_health_fn", ns, nrhs)
        return functools.partial(self._stacked_update_solve_health, sweeps)

    def _stacked_update_solve_health(self, sweeps, factors, A0, Up, Vp, Y, Cinv, wA, b2):
        x = self._one_update_solve(sweeps, factors, A0, Up, Vp, Y, Cinv, b2)
        return x, health_spot_check_slots(self._probe_w_on(b2.device), wA, x, b2, Up, Vp)

    # ------------------------------------------------------------------ #
    # stacked (cold-start) factor programs: the factor lane
    # ------------------------------------------------------------------ #

    def _native_route(self):
        """(factor dtype, backend, panel algo) of the plan's own factor."""
        k = self.key
        return _torch_dtype(k.factor_dtype), k.backend, k.panel_algo

    def _kernel_gate(self, fd: torch.dtype, backend: str) -> bool:
        """True when a factor at dtype `fd` on `backend` runs a batched
        factor kernel (K4 for LU, K5 for Cholesky), the counterpart of the
        JAX `_pallas_factor` gate: the "kernel" backend, LU or Cholesky,
        and float32 or float64 with `dtype == fd` (so the kernel's probe
        row reads the operand `probe_row` would)."""
        k = self.key
        return (backend == "kernel" and k.kind in ("lu", "chol")
                and k.dtype == _dtype_name(fd) and fd in (torch.float32, torch.float64))

    @property
    def _kernel_factor(self) -> bool:
        """True when this plan's own factor runs a batched factor kernel
        (:meth:`_kernel_gate`); other plans factor through
        :meth:`_blocked_factor_core`."""
        fd, backend, _algo = self._native_route()
        return self._kernel_gate(fd, backend)

    def _kernel_factor_core(self, Ast, probe: bool = False):
        """First half of the stacked factor: fold the stack (batched plans
        fold (bb, B) into one kernel batch) and launch K4 or K5. Returns
        (LU, perm[, wA]) or (L[, wA])."""
        shp = Ast.shape
        A2 = Ast.reshape((shp[0] * shp[1],) + shp[2:]) if self.batched else Ast
        w = self._probe_w_on(Ast.device) if probe else None
        if self._spd:
            out = blas.batched_cholesky_factor(A2, probe_w=w, backend="kernel")
            return out if probe else (out,)
        return blas.batched_lu_factor(A2, probe_w=w, backend="kernel")

    def _blocked_factor_core(self, Ast, route, probe: bool = False):
        """First half of the stacked factor outside the kernel gate: fold
        the stack (batched plans fold (bb, B) into one batch), cast it to
        the route's factor dtype and run the batched blocked factor on its
        backend and panel algo, the counterpart of the JAX package's
        vmapped `_one_factor`; with `probe`, the probe rows wA = w^T A off
        the stack in the plan's dtype, as the JAX `_stacked_factor_body`
        computes them beside the factor. Returns (LU, perm[, wA]) or
        (L[, wA])."""
        from conflux_tpu_torch.cholesky.single import cholesky_blocked
        from conflux_tpu_torch.lu.single import lu_factor_blocked

        fd, backend, algo = route
        v = self.key.v
        A2 = Ast.reshape((-1,) + tuple(Ast.shape[-2:]))
        Af = A2.to(fd)
        if self._spd:
            core = (cholesky_blocked(Af, v, backend=backend),)
        else:
            core = lu_factor_blocked(Af, v, backend=backend, panel_algo=algo)
        if not probe:
            return core
        return (*core, probe_row(self._probe_w_on(Ast.device), A2))

    def _qr_factor_core(self, Ast, fd, probe: bool = False):
        """The stacked factor of a QR plan: `qr.single.qr_factor_blocked`
        of each slot at dtype `fd` (panel width min(v, N)), stacked, so a
        slot's factors do not depend on the bucket. Returns (Q, R[, (u,
        uA)]) with the least-squares probe pair of each slot
        (`update.probe_lstsq`)."""
        from conflux_tpu_torch.qr.single import qr_factor_blocked

        v = min(self.key.v, self.N)
        QR = [qr_factor_blocked(a.to(fd), v=v) for a in Ast]
        core = (torch.stack([q for q, _r in QR]), torch.stack([r for _q, r in QR]))
        if not probe:
            return core
        w = self._probe_w_on(Ast.device)
        pairs = [probe_lstsq(w, a) for a in Ast]
        return (*core, (torch.stack([u for u, _ in pairs]),
                        torch.stack([uA for _, uA in pairs])))

    def _factor_core(self, Ast, probe: bool = False, route=None):
        """The stacked factor's first half on `route` (factor dtype,
        backend, panel algo; default the plan's own)."""
        route = self._native_route() if route is None else route
        if self.key.kind == "qr":
            return self._qr_factor_core(Ast, route[0], probe)
        if self._kernel_gate(route[0], route[1]):
            return self._kernel_factor_core(Ast, probe)
        return self._blocked_factor_core(Ast, route, probe)

    def _factor_epilogue(self, core, probe: bool = False, fd=None):
        """Second half: the substitution epilogue on the factor's output
        (per-slot diagonal-block inverses for 'blocked', full triangular
        inverses for 'inv', in the compute dtype of the factor dtype `fd`,
        default the plan's) and the (bb, B) unflatten of batched plans.
        Every op is per slot, so the kernel's per-slot bits survive into
        the session factors."""
        k = self.key
        fd = _torch_dtype(k.factor_dtype) if fd is None else fd
        cdtype = blas.compute_dtype(fd)
        if k.kind == "qr":
            F = (core[0], core[1])
        elif self._spd:
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
            if self.key.kind == "qr":
                return self._qr_factor_health
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

    def _qr_factor_health(self, Ast):
        """The factor lane's checked program of a QR plan: u_i lies in
        range(A_i) (`update.probe_lstsq`), so the least-squares solution of
        A_i x = u_i reproduces u_i and the projected residual
        |u.u - uA.x| / ||u|| vanishes, the square lane's |w.w - wA.x|
        scale (u is normalized to ||u|| = sqrt(M)). Returns (factors,
        (u, uA), verdict (2, bb))."""
        F, wA = self._factor_epilogue(self._factor_core(Ast, probe=True), probe=True)
        u, uA = wA
        x = self._one_solve(F, Ast, u[..., None])
        cdtype = x.dtype
        finite = torch.isfinite(x.sum(dim=tuple(range(1, x.dim()))))
        uc = u.to(cdtype)
        ax = (uA.to(cdtype) * x[..., 0]).sum(-1)
        num = torch.abs((uc * uc).sum(-1) - ax)
        den = torch.sqrt((uc.abs() ** 2).sum(-1)) + torch.finfo(cdtype).tiny
        verdict = torch.stack([finite.to(torch.float32), (num / den).to(torch.float32)])
        return F, wA, verdict

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
        projected-residual check; for a QR plan the least-squares pair
        (u, uA) (`update.probe_lstsq`)."""
        def build():
            if self.key.kind == "qr":
                return lambda A0: probe_lstsq(self._probe_w_on(A0.device), A0)
            return lambda A0: probe_row(self._probe_w_on(A0.device), A0)

        return self._memo(self._solve_cache, ("probe",), build)

    def _verdict(self, wA, x, b2, Up=None, Vp=None):
        """The (2,) verdict of a solve through the session's probe: wA is
        the probe row, or the (u, uA) pair of a QR plan (u in range(A0) is
        orthogonal to the least-squares residual, so the same projected
        check u.b - uA.x vanishes at min ||A x - b||)."""
        if self.key.kind == "qr":
            u, uA = wA
            return health_spot_check(u, uA, x, b2)
        return health_spot_check(self._probe_w_on(b2.device), wA, x, b2, Up, Vp)

    def _checked(self, inner):
        """Wrap a (factors, A0, b2) solve body into the checked shape
        (factors, A0, wA, b2) -> (x, (2,) verdict)."""
        def f(factors, A0, wA, b2):
            x = inner(factors, A0, b2)
            return x, self._verdict(wA, x, b2)

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

    def _one_refine(self, factors, A0, x, b2):
        """One iterative-refinement sweep against the current base factors,
        escalation rung 2's body (rung 1's forced refactor already absorbed
        any drift, so the residual matvec runs against A0)."""
        corr = self._base_corr(factors)
        cdtype = blas.compute_dtype(_torch_dtype(self.key.dtype))
        xc = x.to(cdtype)
        r = b2.to(cdtype) - torch.matmul(A0.to(cdtype), xc)
        return xc + corr(r).to(cdtype)

    def _refine_fn(self, nrhs: int):
        """The checked refinement program per RHS bucket, what
        `SolveSession.refine_checked` runs: (factors, A0, wA, x, b2) ->
        (x2, verdict)."""
        self._check_bucket("_refine_fn", nrhs)

        def build():
            self._bump("refine")

            def f(factors, A0, wA, x, b2):
                x2 = self._one_refine(factors, A0, x, b2)
                return x2, self._verdict(wA, x2, b2)
            return f

        return self._memo(self._solve_cache, ("refine", nrhs), build)

    # ------------------------------------------------------------------ #
    # served precision tiers: the per-request ladder
    # ------------------------------------------------------------------ #

    def _tier_spec(self, tier: str):
        """(factor dtype, fused IR sweeps, (factor dtype, backend, panel
        algo)) of a served tier. 'bf16_ir' factors in bfloat16 and fuses at
        least one sweep (its residual against the session's base); 'f32'
        and 'f64' factor at that dtype with the plan's own sweeps. The route
        is the plan's own where it takes the tier's dtype: on "kernel" a
        float32 or bfloat16 factor (K4/K5 where the kernel gate holds, else
        the batched blocked factor on K2 and K1). K1 and K2 have no float64
        instance, so a float64 tier outside the kernel gate factors on the
        JAX package's default library route, backend "xla" and panel algo
        "auto" (a registry algo other than "kernel" stays): a route chosen
        by dtype, as the kernel gate is."""
        if tier not in PRECISION_TIERS:
            raise ValueError(f"unknown served tier {tier!r} — one of {PRECISION_TIERS}")
        k = self.key
        fd = _TIER_DTYPES[tier]
        sweeps = max(int(k.refine), 1) if tier == "bf16_ir" else int(k.refine)
        backend, algo = k.backend, k.panel_algo
        if (fd == torch.float64 and k.kind != "qr" and backend == "kernel"
                and not self._kernel_gate(fd, backend)):
            backend, algo = "xla", ("auto" if algo == "kernel" else algo)
        return fd, sweeps, (fd, backend, algo)

    def _check_tier(self, what: str, tier: str) -> None:
        if tier not in PRECISION_TIERS:
            raise ValueError(f"{what} takes a served tier from {PRECISION_TIERS}, "
                             f"got {tier!r}")

    def _tier_stacked_factor_fn(self, tier: str, bb: int):
        """The served tiers' coalesced factor program: `bb` systems factored
        at the tier's dtype on its route (:meth:`_tier_spec`) in one call,
        the `("tier_factor", tier, bb)` family beside the native one, with
        the same per-slot bucket invariance."""
        self._check_tier("_tier_stacked_factor_fn", tier)
        self._check_bucket("_tier_stacked_factor_fn", bb)

        def build():
            self._bump("factor")
            fd, _sweeps, route = self._tier_spec(tier)

            def run(Ast):
                return self._factor_epilogue(self._factor_core(Ast, route=route), fd=fd)
            return run

        return self._memo(self._factor_cache, ("tier_factor", tier, bb), build)

    def _tier_factor_once(self, tier: str, A):
        """Factor one system (or one batch) at a served tier through the
        bucket-1 slot of the tier's stacked program: `factor(precision=)`,
        the cross-tier cache and a tier session's refactors route here."""
        F = self._tier_stacked_factor_fn(tier, 1)(A[None])
        return unstack_tree(F, 1)[0]

    def _tier_solve_fn(self, tier: str, nrhs: int):
        """The tiers' substitution program per RHS bucket: the tier's
        factors and fused sweeps against the base, (factors, A0, b2) -> x
        (A0 is always read: bf16_ir sweeps at least once)."""
        self._check_tier("_tier_solve_fn", tier)
        self._check_bucket("_tier_solve_fn", nrhs)
        _fd, sweeps, _route = self._tier_spec(tier)

        def build():
            self._bump("solve")
            return functools.partial(self._tier_one_solve, sweeps)

        return self._memo(self._solve_cache, ("tier", tier, nrhs), build)

    def _tier_one_solve(self, sweeps, factors, A0, b2):
        return self._one_solve(factors, A0, b2, sweeps=sweeps)

    def _tier_solve_health_fn(self, tier: str, nrhs: int):
        """The checked tier substitution per RHS bucket, what 'auto'
        requests run (the verdict is the ladder's escalation signal):
        always the unfused :meth:`_checked` shape, as in the JAX package."""
        self._check_tier("_tier_solve_health_fn", tier)
        self._check_bucket("_tier_solve_health_fn", nrhs)
        _fd, sweeps, _route = self._tier_spec(tier)

        def build():
            self._bump("solve")
            self._bump("health")
            return self._checked(functools.partial(self._tier_one_solve, sweeps))

        return self._memo(self._solve_cache, ("tier_health", tier, nrhs), build)

    # ------------------------------------------------------------------ #
    # Woodbury update programs, built once per bucket
    # ------------------------------------------------------------------ #

    def _one_update(self, factors, Up, Vp):
        """(Y, Cinv, cond1) of the drift (Up, Vp) against the base factors:
        one base substitution with Up's kb columns (one K3 round on a
        blocked plan)."""
        return capacitance(self._base_corr(factors), Up, Vp)

    def _one_update_solve(self, sweeps, factors, A0, Up, Vp, Y, Cinv, b2):
        """Woodbury-corrected substitution plus `sweeps` refinement sweeps
        against the drifted matrix (residual A0 x + U (V^H x))."""
        corr = self._base_corr(factors)
        cdtype = blas.compute_dtype(_torch_dtype(self.key.dtype))
        x = woodbury_apply(corr, Y, Cinv, Vp, b2).to(cdtype)
        bc = b2.to(cdtype)
        for _ in range(sweeps):
            r = bc - updated_matvec(A0, Up, Vp, x)
            x = x + woodbury_apply(corr, Y, Cinv, Vp, r).to(cdtype)
        return x

    def _update_fn(self, kb: int):
        """The capacitance program per rank bucket kb:
        (factors, Up, Vp) -> (Y, Cinv, cond1)."""
        self._check_bucket("_update_fn", kb)

        def build():
            self._bump("update")
            return self._one_update

        return self._memo(self._update_cache, ("update", kb), build)

    def _update_solve_fn(self, kb: int, nrhs: int, sweeps: int):
        """The Woodbury solve program per (rank bucket, RHS bucket,
        backstop sweeps): (factors, A0, Up, Vp, Y, Cinv, b2) -> x."""
        self._check_bucket("_update_solve_fn", nrhs)

        def build():
            self._bump("update_solve")
            return functools.partial(self._one_update_solve, sweeps)

        return self._memo(self._update_cache, ("usolve", kb, nrhs, sweeps), build)

    def _update_solve_health_fn(self, kb: int, nrhs: int, sweeps: int):
        """The checked Woodbury solve program: the projected residual goes
        through the drifted matrix (w^T A1 = wA + (w^T Up) Vp^H, padded
        columns inert), so a correction gone wrong trips the verdict."""
        self._check_bucket("_update_solve_health_fn", nrhs)

        def build():
            self._bump("update_solve")
            self._bump("health")

            def f(factors, A0, Up, Vp, Y, Cinv, wA, b2):
                x = self._one_update_solve(sweeps, factors, A0, Up, Vp, Y, Cinv, b2)
                return x, self._verdict(wA, x, b2, Up, Vp)
            return f

        return self._memo(self._update_cache, ("uhealth", kb, nrhs, sweeps), build)

    def _refresh_fn(self, kb: int, donate: bool = False):
        """The drifted base A0 + U V^H per rank bucket, the refactor's
        input. With `donate` (the session owns its base: it came from an
        earlier refactor, not from the caller) A0 is updated in place by
        one `addmm_` (`baddbmm_` for a batch), so a drifting session holds
        one resident base at the refactor peak, the role of the JAX
        package's buffer donation; otherwise (and for bfloat16 storage,
        whose sum runs in float32) a new tensor by the same product
        (`update.apply_update`), with the same bits."""
        def build():
            def in_place(A0, Up, Vp):
                cdtype = blas.compute_dtype(A0.dtype)
                if A0.dtype != cdtype:
                    return apply_update(A0, Up, Vp)
                add = A0.addmm_ if A0.dim() == 2 else A0.baddbmm_
                return add(Up.to(cdtype), Vp.to(cdtype).mH)
            return in_place if donate else apply_update

        return self._memo(self._update_cache, ("refresh", kb, donate), build)

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
               sid=None, precision: str | None = None) -> "SolveSession":
        """Factor A and open a session on its device-resident factors.

        A (numpy or tensor) is put on `device`: the card unless the caller
        passes device="cpu" (no card and no "cpu" raises). The session
        keeps A itself when the plan refines (the residual matvec) and as
        the base of its probe row and of its drift. `policy` governs when
        `session.update` drifts refactor (default :class:`DriftPolicy`).
        `precision` opens the session at a served tier: its factors are
        built at the tier's dtype directly, and its solves default to the
        tier's programs; 'auto' opens on the cheapest rung. None is the
        native path. `sid` is the session's stable id (the engine places
        and names sessions by it)."""
        tier0 = check_precision_request(precision)
        if tier0 == "auto":
            tier0 = PRECISION_TIERS[0]
        dev = resolve_device(device)
        A = _as_tensor(A, dev)
        self._check_A(A)
        with profiler.region("serve.factor"):
            factors = (self._factor_once(A) if tier0 is None
                       else self._tier_factor_once(tier0, A))
        # tier sessions keep the base: their solves sweep against it
        keep_A = A if (self.key.refine or tier0 is not None) else None
        return SolveSession(self, factors, keep_A, A, policy, device=dev, sid=sid,
                            served_tier=tier0)


class SolveSession:
    """Device-resident factors + the plan's substitution programs.

    `solves` and `factorizations` count what this session ran: solve-only
    traffic keeps `factorizations == 1`. `update(U, V)` applies a rank-k
    drift A <- A + U V^H without refactoring (the Woodbury correction,
    `update`); the session's :class:`DriftPolicy` pays one true
    refactorization through the plan's factor program when the
    accumulated rank or the capacitance's condition stops paying
    (`refactors` counts them).
    """

    def __init__(self, plan: FactorPlan, factors, A, A_base=None,
                 policy: DriftPolicy | None = None, *, device=None, sid=None,
                 served_tier=None, auto_rung: int = 0):
        self.plan = plan
        self.device = device
        # the stable session id (engine placement, checkpoint records)
        self.sid = sid
        # every mutation of the resident state, and every read of it,
        # happens under this re-entrant lock (the escalation ladder
        # re-enters it)
        self._lock = threading.RLock()
        self._factors = factors    # guarded-by: _lock
        self._A = A                # guarded-by: _lock
        self._A0 = A if A_base is None else A_base  # guarded-by: _lock
        self.policy = DriftPolicy() if policy is None else policy
        # the Woodbury state: dict(k, kb, Up, Vp, Y, Cinv), None undrifted
        self._upd = None           # guarded-by: _lock
        # the base is the caller's tensor until the first refactor
        # replaces it with one the session made; only an owned base is
        # updated in place (FactorPlan._refresh_fn), and only while no
        # engine lane has read it (`_lane_reads_base`)
        self._owns_base = False    # guarded-by: _lock
        self._base_shared = False  # guarded-by: _lock
        # attached lazily by resilience.breaker_for
        self._breaker = None
        # the latest capacitance condition estimate (SolveUnhealthy evidence)
        self.last_cond = None      # guarded-by: _lock
        # wA = w^T A0 ((u, uA) for QR), computed on the first checked
        # solve, dropped when a refactor replaces the base
        self._probe = None         # guarded-by: _lock
        # the served tier the resident factors were built at (None: the
        # plan's native factor), the sticky 'auto' rung, and the derived
        # per-tier factors of cross-tier requests (rebuildable from _A0,
        # so left out of nbytes, and dropped on every base swap)
        self._served_tier = served_tier  # guarded-by: _lock
        self._auto_rung = int(auto_rung)  # guarded-by: _lock
        self._tier_factors: dict = {}  # guarded-by: _lock
        self.precision_escalations = 0  # guarded-by: _lock
        self.precision_fallbacks = 0  # guarded-by: _lock
        self.factorizations = 1    # guarded-by: _lock
        self.solves = 0            # guarded-by: _lock
        self.updates = 0           # guarded-by: _lock
        self.refactors = 0         # guarded-by: _lock
        # the checkpoint dirty clock: bumped by every mutation of what a
        # checkpoint holds (update, refactor, a moved 'auto' rung, a device
        # move, adoption by a ResidentSet); solve-only traffic leaves it,
        # so an incremental checkpoint (`tier.save_fleet(base=...)`)
        # carries the session's previous record
        self._ckpt_ver = 0         # guarded-by: _lock
        # tiered residency (`tier.ResidentSet`): the managing set (None:
        # untiered), the spill record while the state lives off the card
        # (every state-touching method faults it back in first,
        # `_ensure_resident`, under this lock), and the LRU clock (one int
        # write per touch, read racily by the manager's eviction)
        self._residency = None
        self._spill = None         # guarded-by: _lock
        self._tier_stamp = 0
        # gang residency (`gang.SessionGang`): the gang holding a slot for
        # this session (None: unganged), the slot, and the write-back
        # clock: every mutation of the resident state bumps `_gang_ver`,
        # and the gang rewrites the slot when its copy is older
        self._gang = None
        self._gang_slot = None
        self._gang_ver = 0         # guarded-by: _lock

    @property
    def factors(self):
        """The device-resident factors. LU plans: (LU, Dl, Du, perm) for
        'blocked', (LU, perm) for 'trsm', (Li, Ui, perm) for 'inv'. SPD
        plans: (L, Dl) for 'blocked', (L,) for 'trsm', (Li,) for 'inv'. QR
        plans: the thin (Q, R)."""
        with self._lock:
            return self._factors

    @property
    def served_tier(self):
        """The served tier the resident factors carry (None: the plan's
        native factor dtype)."""
        with self._lock:
            return self._served_tier

    @property
    def auto_rung(self) -> int:
        """The sticky 'auto' ladder position (an index into
        `PRECISION_TIERS`); escalations ratchet it up."""
        with self._lock:
            return self._auto_rung

    @property
    def update_rank(self) -> int:
        """Accumulated drift rank since the last (re)factorization (a
        spilled session reports its record's, without faulting in)."""
        with self._lock:
            if self._spill is not None and self._spill.meta:
                u = self._spill.meta.get("upd")
                return 0 if u is None else u["k"]
            return 0 if self._upd is None else self._upd["k"]

    # requires-lock: _lock
    def _ensure_resident(self) -> None:
        """Fault a spilled session back in and stamp the LRU clock: the
        revival hook every state-touching method runs first, under the
        session lock (a request never sees half-restored state). Untiered
        sessions pay two attribute reads."""
        if self._spill is not None:
            if self._residency is None:
                raise resilience.SessionSpilled(
                    "session is spilled but no ResidentSet manages it (the manager "
                    "detached or the record was grafted): revive through "
                    "ResidentSet.fault_in")
            self._residency.fault_in(self)
        rs = self._residency
        if rs is not None:
            self._tier_stamp = rs._tick()

    @property
    def tier(self) -> str:
        """'device' (resident), 'host' or 'disk' (spilled), or 'corrupt'
        (a record that failed its integrity check: `RestoreCorrupt`)."""
        with self._lock:
            return "device" if self._spill is None else self._spill.tier

    @property
    def nbytes(self) -> int:
        """Device-resident footprint in bytes: factors, base matrix, the
        Woodbury state and the cached probe, each buffer counted once (`_A`
        aliases `_A0` whenever the plan keeps it); the derived cross-tier
        factors are left out. 0 while spilled: the spill record accounts
        its own host or disk bytes (`tier.ResidentSet` and
        `engine.stats()` read this)."""
        with self._lock:
            leaves = [*(self._factors or ()), self._A, self._A0]
            leaves += list(self._probe) if isinstance(self._probe, tuple) else [self._probe]
            if self._upd is not None:
                leaves += [self._upd[k] for k in ("Up", "Vp", "Y", "Cinv")]
            seen: dict[int, int] = {}
            for leaf in leaves:
                if leaf is not None:
                    seen[id(leaf)] = leaf.numel() * leaf.element_size()
            return sum(seen.values())

    def to_device(self, device) -> "SolveSession":
        """Move the session's resident state to `device` and pin it there,
        the engine's placement hook. One copy per distinct tensor
        (`batched.put_tree` keeps `_A` aliased to `_A0`, so `nbytes` still
        counts the base once); the derived cross-tier factors are dropped
        (rebuilt on the new device when asked for). `device=None`, or the
        device the session is already on, changes nothing. Runs under the
        session lock: a concurrent solve never sees half-moved state. A
        ganged session leaves its gang (the stack stays on the old device;
        the session joins its new lane's gang at its next stacked
        dispatch). Returns self."""
        if device is None:
            return self
        dev = resolve_device(device)
        with self._lock:
            self._ensure_resident()
            if self.device is not None and same_device(self.device, dev):
                return self
            moved = put_tree(
                {"f": self._factors, "A": self._A, "A0": self._A0, "probe": self._probe,
                 "upd": (None if self._upd is None else
                         {k: self._upd[k] for k in ("Up", "Vp", "Y", "Cinv")})},
                dev)
            self._factors = moved["f"]
            self._A = moved["A"]
            self._A0 = moved["A0"]
            self._probe = moved["probe"]
            self._tier_factors = {}  # derived state stays device-local
            if self._upd is not None:
                self._upd = {**self._upd, **moved["upd"]}
            self.device = dev
            self._gang_ver += 1
            self._ckpt_ver += 1
            if self._gang is not None:
                # the gang orders its lock after this one (gang.py)
                self._gang.release(self)
        return self

    # requires-lock: _lock
    def _lane_reads_base(self) -> None:
        """Note that work queued on an engine lane's stream reads the base
        (a solve's sweeps, a probe row, a gang slot's copy). Until the next
        refactor replaces it, a refactor makes a new base rather than
        updating this one in place on the caller's stream, which the lane
        is not ordered after: queued lane work never reads a half-drifted
        base. The lane's references keep the old base alive."""
        self._base_shared = True

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

    @staticmethod
    def _unbucket(x, nb, nrhs, squeeze):
        if nb != nrhs:
            x = x[..., :nrhs]
        return x[..., 0] if squeeze else x

    # requires-lock: _lock
    def _resolve_tier(self, precision):
        """A per-request ``precision=`` as a served tier, or None for the
        native programs. None defers to the tier the session was opened at;
        'auto' reads the sticky rung. A drifted session answers a
        cross-tier request on its resident Woodbury path (a derived tier's
        factors carry no drift), counted in `precision_fallbacks`."""
        tier = check_precision_request(precision)
        if tier is None:
            return self._served_tier
        if tier == "auto":
            tier = PRECISION_TIERS[min(self._auto_rung, len(PRECISION_TIERS) - 1)]
        if self._upd is not None and tier != self._served_tier:
            self.precision_fallbacks += 1
            return self._served_tier
        return tier

    # requires-lock: _lock
    def _tier_factor(self, tier):
        """The derived per-tier factors of `_A0` at a tier other than the
        session's own, built once through the plan's tier program."""
        F = self._tier_factors.get(tier)
        if F is None:
            F = self.plan._tier_factor_once(tier, self._A0)
            self._tier_factors[tier] = F
        return F

    # requires-lock: _lock
    def _factor_base(self, A):
        """The session's resident factors of base `A` at its serving
        configuration (its tier's program for a tier session), what every
        refactor runs."""
        if self._served_tier is None:
            return self.plan._factor_once(A)
        return self.plan._tier_factor_once(self._served_tier, A)

    def solve(self, b, *, precision=None):  # hot-path
        """Solve against the resident factors: the substitution plus the
        plan's `refine` sweeps, plus the Woodbury correction while the
        session carries a drift. b is (N,)/(N, k) for single plans,
        (B, N)/(B, N, k) for batched ones ((M,)/(M, k) for QR plans, whose
        x has N rows); x comes back in b's shape. Widths are padded up to
        power-of-two buckets and sliced back. `precision` routes this
        request through a served tier's programs (factors derived once when
        it is not the session's own tier); nothing here waits for the
        card."""
        plan = self.plan
        b2, nb, nrhs, squeeze = self._rhs_bucketed(b)
        with self._lock:
            self._ensure_resident()
            tier = self._resolve_tier(precision)
            with profiler.region("serve.solve"):
                if self._upd is not None:
                    u = self._upd
                    sweeps = plan.key.refine + self.policy.refine
                    x = plan._update_solve_fn(u["kb"], nb, sweeps)(
                        self._factors, self._A0, u["Up"], u["Vp"], u["Y"], u["Cinv"], b2)
                elif tier is None:
                    x = plan._solve_fn(nb)(self._factors, self._A, b2)
                else:
                    F = self._factors if tier == self._served_tier else self._tier_factor(tier)
                    x = plan._tier_solve_fn(tier, nb)(F, self._A0, b2)
            self.solves += 1
        return self._unbucket(x, nb, nrhs, squeeze)

    def _probe_row(self):
        """The session's cached probe row wA = w^T A0 ((u, uA) for a QR
        plan): device-resident, once per base."""
        with self._lock:
            self._ensure_resident()
            if self._probe is None:
                self._probe = self.plan._probe_fn()(self._A0)
                # made on an engine lane's stream, it is used on the
                # callers' default stream too
                hand_to_default(self._probe)
            return self._probe

    def solve_checked(self, b, *, precision=None):  # hot-path
        """`solve` plus the finite/projected-residual health verdict, in
        the same program: returns (x, verdict), verdict a (2,) float32
        tensor [finite_flag, residual] on the session's device (nothing
        here waits for the card). A drifted session's verdict projects
        through the drifted matrix."""
        plan = self.plan
        b2, nb, nrhs, squeeze = self._rhs_bucketed(b)
        with self._lock:
            self._ensure_resident()
            tier = self._resolve_tier(precision)
            wA = self._probe_row()
            with profiler.region("serve.solve"):
                if self._upd is not None:
                    u = self._upd
                    sweeps = plan.key.refine + self.policy.refine
                    x, verdict = plan._update_solve_health_fn(u["kb"], nb, sweeps)(
                        self._factors, self._A0, u["Up"], u["Vp"], u["Y"], u["Cinv"],
                        wA, b2)
                elif tier is None:
                    x, verdict = plan._solve_health_fn(nb)(self._factors, self._A0, wA, b2)
                else:
                    F = self._factors if tier == self._served_tier else self._tier_factor(tier)
                    x, verdict = plan._tier_solve_health_fn(tier, nb)(F, self._A0, wA, b2)
            self.solves += 1
        return self._unbucket(x, nb, nrhs, squeeze), verdict

    def refine_checked(self, b, x):
        """One iterative-refinement sweep of an earlier answer `x` against
        the current base factors, re-checked: escalation rung 2
        (`resilience.escalate`). `b` and `x` carry a solve's shapes; a
        drifted session must refactor first (rung 1 precedes this one)."""
        plan = self.plan
        b2, nb, nrhs, squeeze = self._rhs_bucketed(b)
        x2 = _as_tensor(x, self.device)
        if squeeze:
            x2 = x2[..., None]
        if nb != nrhs:
            x2 = torch.nn.functional.pad(x2, (0, nb - nrhs))
        with self._lock:
            self._ensure_resident()
            if self._upd is not None:
                raise AssertionError(
                    "refine_checked rides the base factors — refactor() the drifted "
                    "session first (escalation rung order)")
            with profiler.region("serve.solve"):
                x2, verdict = plan._refine_fn(nb)(self._factors, self._A0,
                                                  self._probe_row(), x2, b2)
        return self._unbucket(x2, nb, nrhs, squeeze), verdict

    def refactor(self):
        """One true refactorization through the plan's factor program,
        escalation rung 1: absorbs an accumulated drift into a fresh base
        (:meth:`_refactor`); an undrifted session refactors its resident
        base, replacing possibly corrupt factors. Returns self."""
        with self._lock:
            self._ensure_resident()
            if self._upd is not None:
                k = self._upd["k"]
                self._refactor(self._upd["Up"][..., :k], self._upd["Vp"][..., :k])
                return self
            with profiler.region("serve.refactor"):
                resilience.maybe_fault(None, "refresh")
                self._factors = None  # released before the factor runs
                self._factors = self._factor_base(self._A0)
                # derived factors die with the rung-1 rebuild too
                self._tier_factors = {}
            self.factorizations += 1
            self.refactors += 1
            self._ckpt_ver += 1
            self._gang_ver += 1  # the gang slot is stale: lazy re-sync
            return self

    def _check_uv(self, U, V):
        plan = self.plan
        if tuple(U.shape) != tuple(V.shape):
            raise ValueError(f"U {tuple(U.shape)} and V {tuple(V.shape)} must agree")
        lead = (plan.B, plan.N) if plan.batched else (plan.N,)
        if U.dim() != len(lead) + 1 or tuple(U.shape[:-1]) != lead:
            raise ValueError(f"update factors {tuple(U.shape)}, session needs {lead} "
                             "(+ rank axis)")
        if U.shape[-1] < 1:
            raise ValueError("update rank must be >= 1")

    def update(self, U, V, *, replace: bool = False):
        """Apply the rank-k drift A <- A + U V^H without refactoring.

        U, V are (N, k) for single plans, (B, N, k) for batched ones
        (k << N). Updates accumulate (ranks add) unless `replace=True`,
        which measures the drift from the base factors again, the
        "rank-k drift per request" traffic shape. The capacitance is one
        base substitution with the rank bucket's columns; its condition
        estimate is read on the host (the drift policy's decision, and why
        this is not a hot-path method). The policy refactors once the
        accumulated rank exceeds `policy.max_rank` or the condition exceeds
        `policy.cond_limit`. Returns self."""
        plan = self.plan
        if plan.key.kind == "qr":
            raise ValueError(
                "incremental (Woodbury) drift updates apply to square plans — a "
                "kind='qr' least-squares session re-factors on base change (the "
                "Woodbury identity corrects A^-1, not the pseudoinverse)")
        dtype = _torch_dtype(plan.key.dtype)
        U = _as_tensor(U, self.device).to(dtype)
        V = _as_tensor(V, self.device).to(dtype)
        self._check_uv(U, V)
        with self._lock, profiler.region("serve.update"):
            self._ensure_resident()
            if self._upd is not None:
                if not replace:
                    k0 = self._upd["k"]
                    U = torch.cat([self._upd["Up"][..., :k0], U], -1)
                    V = torch.cat([self._upd["Vp"][..., :k0], V], -1)
                # the superseded state is dead before the new one is built
                self._upd = None
            k = U.shape[-1]
            if k > self.policy.resolved_max_rank(plan.N):
                self._refactor(U, V)
                return self
            kb = rank_bucket(k)
            if kb != k:
                U = torch.nn.functional.pad(U, (0, kb - k))
                V = torch.nn.functional.pad(V, (0, kb - k))
            Y, Cinv, cond1 = plan._update_fn(kb)(self._factors, U, V)
            # the deliberate host read: the policy's decision is host control
            cond = float(cond1.max())
            self.last_cond = cond
            if not cond <= self.policy.cond_limit:  # NaN and inf too
                resilience.bump("cond_refactors")
                self._refactor(U, V)
                return self
            self._upd = {"k": k, "kb": kb, "Up": U, "Vp": V, "Y": Y, "Cinv": Cinv}
            self.updates += 1
            self._ckpt_ver += 1
            self._gang_ver += 1  # the gang slot is stale: lazy re-sync
            if self._residency is not None:
                # the Woodbury state grew the footprint
                self._residency._note_bytes(self)
        return self

    def _refactor(self, Up, Vp):
        """The drift policy's trigger: form A0 + U V^H and pay one true
        refactorization through the plan's factor program; the base absorbs
        the drift and the correction resets."""
        plan = self.plan
        with self._lock, profiler.region("serve.refactor"):
            resilience.maybe_fault(None, "refresh")
            k = Up.shape[-1]
            kb = rank_bucket(k)
            if kb != k:  # zero columns leave A0 + U V^H unchanged
                Up = torch.nn.functional.pad(Up, (0, kb - k))
                Vp = torch.nn.functional.pad(Vp, (0, kb - k))
            # the superseded state is dead once the new base exists: drop it
            # first, and update an owned base in place, so the peak holds one
            # base and one factor set
            self._upd = None
            donate = self._owns_base and not self._base_shared
            A_new = plan._refresh_fn(kb, donate=donate)(self._A0, Up, Vp)
            self._A0 = A_new
            self._base_shared = False
            self._probe = None  # against the superseded base
            self._tier_factors = {}
            self._owns_base = True
            if self._A is not None:
                self._A = A_new
            self._factors = None  # released before the factor runs
            self._factors = self._factor_base(A_new)
            self.factorizations += 1
            self.refactors += 1
            self._ckpt_ver += 1
            self._gang_ver += 1  # the gang slot is stale: lazy re-sync
            if self._residency is not None:
                # the Woodbury state is gone and the base may be new
                self._residency._note_bytes(self)


def session_from_numpy(plan: FactorPlan, factors, A, device=None) -> SolveSession:
    """Open a port session on factors made elsewhere, for example the
    factor pytree of a JAX `SolveSession` as numpy arrays, in the layout
    of :attr:`SolveSession.factors`: (LU, Dl, Du, perm) for a blocked LU
    plan, (LU, perm) for 'trsm', (Li, Ui, perm) for 'inv'; (L, Dl), (L,)
    and (Li,) for an SPD plan; (Q, R) for a QR plan. A is the matrix they factor (the probe
    row's base, and the refinement sweeps' matvec). The counterpart of
    `lu.single.state_from_numpy`."""
    spd = plan._spd
    lu = plan.key.kind == "lu"
    want = 2 if plan.key.kind == "qr" else ({"blocked": 2, "trsm": 1, "inv": 1} if spd else
                                           {"blocked": 4, "trsm": 2, "inv": 3})[
        plan.key.substitution]
    if len(factors) != want:
        raise ValueError(f"a {plan.key.substitution!r} {plan.key.kind} plan's "
                         f"factors have {want} leaves, got {len(factors)}")
    dev = resolve_device(device)
    # an LU plan's last leaf is its permutation
    F = tuple(from_numpy(np.asarray(f).astype(np.int64) if lu and i == want - 1
                         else np.asarray(f), dev)
              for i, f in enumerate(factors))
    A = _as_tensor(A, dev)
    plan._check_A(A)
    return SolveSession(plan, F, A if plan.key.refine else None, A, device=dev)
