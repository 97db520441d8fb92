"""End-to-end DMO compile pipeline (pass manager + content-addressed cache).

The paper's §II techniques — operation removal (§II.C), operation splitting
(§II.A), graph serialisation (§II.B), diagonal arena planning (§II.D/§IV) and
bit-exact verification (§I) — compose: removal exposes new diagonal cascades,
splitting changes the peak-defining pair, and the serialisation order decides
which tensors the planner can overlap. Each caller re-implementing that
plumbing (build → transform → order → plan → compare → validate) is exactly
the boilerplate this module deletes.

:func:`compile` is the single planning entrypoint::

    from repro_torch.core.pipeline import compile
    plan = compile(graph)                  # default pass chain
    print(plan.report())                   # peak, savings, pass log, layout

Passes are registered with the :func:`register_pass` decorator and are
individually toggleable via ``compile(..., passes=(...))``. Compiled plans
are memoised in a content-addressed cache keyed by a deterministic graph
signature (op kinds, params, tensor shapes/dtypes/kinds/aliasing) plus the
compile options, so re-planning the same model is O(signature) instead of
O(NP-hard search).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import pathlib
import pickle
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core import exec as X
from repro_torch.core import planner as P
from repro_torch.core.arena import run_reference
from repro_torch.core.graph import Graph, Op, Tensor
from repro_torch.core.removal import removable, remove_concats
from repro_torch.core.serialise import candidate_orders
from repro_torch.core.splitting import auto_split, order_pinned

__all__ = [
    "CompileOptions", "CompiledPlan", "Pass", "auto_budget_s",
    "available_passes", "cache_clear", "cache_info", "compile",
    "compile_many", "default_passes", "graph_signature", "peak_vs_batch",
    "register_pass",
]


# ---------------------------------------------------------------------------
# Graph signatures (content addressing)
# ---------------------------------------------------------------------------


def _canon(v: Any) -> Any:
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _canon(x)) for k, x in v.items()))
    return v


def graph_signature(graph: Graph) -> str:
    """Deterministic content hash of a graph: op kinds + params and tensor
    shapes/dtypes/kinds/alias structure, with tensors numbered in first-use
    order (names are ignored, so a rebuilt identical model hits the cache)."""
    h = hashlib.sha256()
    ids: Dict[int, int] = {}

    def ref(t: Tensor) -> str:
        k = id(t)
        if k not in ids:
            alias = ref(t.alias_of) if t.alias_of is not None else ""
            ids[k] = len(ids)
            # batch folds in only when != 1 so batch-1 hashes (and their
            # persisted disk entries) are stable across this change
            batch = f":b{t.batch}" if t.batch > 1 else ""
            h.update(f"T{ids[k]}:{t.shape}:{t.dtype_bytes}:{t.kind}"
                     f"{batch}:a({alias});".encode())
        return str(ids[k])

    for op in graph.ops:
        ins = ",".join(ref(t) for t in op.inputs)
        outs = ",".join(ref(t) for t in op.outputs)
        h.update(f"O:{op.kind}|{ins}|{outs}|{_canon(op.params)!r};".encode())
    for t in graph.tensors:  # dangling model inputs still occupy the arena
        ref(t)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Options / state / result
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    profile: str = "paper"        # overlap profile: "paper" | "extended"
    method: str = "algorithmic"   # O_s method: analytic/algorithmic/trace/auto
    #: ILS search budget: seconds (>0 enables), or "auto" to derive the
    #: budget from the graph's op/tensor count (see :func:`auto_budget_s`).
    budget_s: Union[float, str] = 0.0
    seed: int = 0
    #: Joint execution-order x overlap search: "auto" (runs whenever a search
    #: budget is set), "on" (forced, with a 1 s floor budget), "off" (the
    #: placement-only plan_search refinement of the fixed serialised order).
    #: Folded into the plan-cache key via :meth:`key` like every option.
    order_search: str = "auto"
    split: str = "auto"           # "auto" (size-gated) | "on" | "off"
    split_max_parts: int = 8
    split_ops_limit: int = 150    # "auto": skip auto_split on larger graphs
    fuse: str = "auto"            # band-chain fusion: "auto" | "on" | "off"
    #: Scratch budget (bytes) the FusePass gates per-chain scratch estimates
    #: against; None = the REPRO_DMO_VMEM_BUDGET env var, else
    #: :data:`TPU_FUSE_BUDGET` (16 MiB).
    fuse_vmem_budget: Optional[int] = None
    verify: str = "auto"          # "auto" | "constraints" | "numeric" | "off"
    backend: str = "numpy"        # executor backend a plan is compiled for
    #: Leading batch axis the plan is compiled for: the graph is rewritten
    #: through :func:`repro_torch.core.graph.with_batch` before any pass runs, so
    #: every row count, O_s distance and streaming window scales with it.
    #: Part of :meth:`key` (``astuple``), so each batch variant is its own
    #: content-addressed cache entry — memory and disk tiers both.
    batch: int = 1

    def key(self) -> str:
        return repr(dataclasses.astuple(self))


def auto_budget_s(graph: Graph) -> float:
    """ILS wall budget derived from graph size (replaces the hand-set
    per-benchmark budgets). One ILS step re-places every tensor against every
    placed tensor, so its cost grows ~T^1.5..2 with the tensor count and a
    fixed wall budget yields ever fewer iterations on the big connected
    graphs — where the search rarely beats the greedy seeds anyway. Target a
    roughly constant iteration count instead: generous on the ~30-tensor
    MobileNets (where the paper's optimal cascades hide), tapering to the
    floor at NasNet scale. Tiny graphs also need less wall time (the
    insertion-order space itself is small), so the budget additionally grows
    ~0.4 s per op from below. Clamped to [0.5, 12] seconds."""
    t = max(1, len(graph.arena_tensors()))
    b = min(0.4 * len(graph.ops), 1e4 / (t * math.sqrt(t)))
    return float(min(12.0, max(0.5, b)))


@dataclasses.dataclass
class PipelineState:
    """Mutable state threaded through the pass chain."""
    original: Graph
    options: CompileOptions
    #: (provenance label, graph) — variants[0] is always the input graph;
    #: transform passes append rewritten graphs.
    variants: List[Tuple[str, Graph]]
    #: candidate execution orders per variant index (serialise pass).
    orders: Dict[int, List[List[Op]]] = dataclasses.field(default_factory=dict)
    baseline: Optional[P.Plan] = None
    #: fixed-order plan_dmo candidates per (variant, order) — computed by
    #: OrderSearchPass when it runs (PlanPass reuses them instead of
    #: re-planning the grid), else by PlanPass itself.
    fixed_plans: Optional[List[Tuple[str, P.Plan]]] = None
    #: the joint order x overlap search's winner (label, plan), competing
    #: against the fixed-order candidates in PlanPass.
    joint: Optional[Tuple[str, P.Plan]] = None
    order_stats: Optional[Dict[str, Any]] = None
    plan: Optional[P.Plan] = None
    winner: str = "input"
    verified: str = "none"
    recompute_elems: int = 0
    log: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CompiledPlan:
    """Result of :func:`compile`: the winning plan, the non-overlapping
    baseline it is measured against, and the full pass provenance.

    Cache-hit note: a hit returns the memoised result, whose ``original`` /
    ``graph`` / ``plan`` reference the *first* structurally identical graph
    compiled — not necessarily the object you just passed in. Correlate
    through ``compiled.graph`` and ``compiled.plan`` (or
    :meth:`offsets_by_name`), never through your local build's Tensor/Op
    objects."""
    original: Graph
    graph: Graph            # graph the plan executes (possibly transformed)
    plan: P.Plan
    baseline: P.Plan
    passes: Tuple[str, ...]
    log: List[str]
    key: str
    winner: str             # provenance label of the winning variant
    verified: str           # "numeric" | "constraints" | "none"
    recompute_elems: int = 0
    cache_hit: bool = False
    compile_s: float = 0.0
    backend: str = "numpy"      # executor backend this plan was compiled for
    #: telemetry from the joint execution-order x overlap search (None when
    #: the order_search pass was off / skipped): fixed vs joint peaks, move
    #: and promotion counts, wall time, whether the winning order changed.
    order_stats: Optional[Dict[str, Any]] = None

    @property
    def peak_bytes(self) -> int:
        return self.plan.peak_bytes

    def execute(self, inputs=None, weights=None, *, seed: int = 0,
                backend: Optional[str] = None,
                quant: Optional[Any] = None) -> Dict[str, Any]:
        """Run the plan inside its arena on the compiled-for executor backend
        (override with ``backend=``). Inputs/weights default to the
        deterministic synthesis shared by all backends; int8 graphs take a
        :class:`~repro_torch.core.exec.ops.QuantSpec` via ``quant`` (auto-calibrated
        when omitted). Returns the model outputs keyed by tensor name."""
        be = X.get_backend(backend or self.backend)
        return be.execute(self, inputs, weights, seed=seed, quant=quant)

    @property
    def baseline_bytes(self) -> int:
        return self.baseline.peak_bytes

    @property
    def saving_pct(self) -> float:
        if self.baseline_bytes == 0:
            return 0.0
        return 100.0 * (1.0 - self.peak_bytes / self.baseline_bytes)

    def offsets_by_name(self) -> Dict[str, int]:
        """Arena offsets keyed by tensor *name*. On a cache hit the plan's
        Tensor objects belong to the memoised graph, not necessarily the one
        passed to :func:`compile` — names survive that, object identity
        does not."""
        return {t.name: off for t, off in self.plan.offsets.items()}

    def legalised(self) -> Optional[P.BlockPlan]:
        """The plan legalised onto the row-blocked (tiled) arena grid —
        what compiled-mode Pallas execution allocates — or ``None`` when no
        row-blocked arena can express it (mixed dtypes, aggregated
        views)."""
        try:
            return P.legalise_for_blocks(self.plan)
        except ValueError:
            return None

    def report(self) -> str:
        lines = [
            f"# compile({self.original.name}): {self.peak_bytes} bytes "
            f"({self.peak_bytes / 1024:.1f} KB), "
            f"{self.saving_pct:.1f}% below baseline "
            f"{self.baseline_bytes / 1024:.1f} KB [{self.baseline.strategy}]",
            f"  strategy={self.plan.strategy} variant={self.winner} "
            f"backend={self.backend} verified={self.verified} "
            f"cache={'hit' if self.cache_hit else 'miss'} "
            f"compile={self.compile_s * 1e3:.1f} ms",
            f"  passes: {' -> '.join(self.passes)}",
        ]
        bp = self.legalised()
        if bp is not None:
            lines.append(
                f"  row-blocked (tile {bp.tiling[0]}x{bp.tiling[1]}): "
                f"{bp.padded_peak_bytes} bytes "
                f"({bp.padded_peak_bytes / 1024:.1f} KB), "
                f"+{bp.padding_overhead_pct:.1f}% tiling padding over the "
                "byte-granular peak")
        if self.recompute_elems:
            lines.append(f"  recompute: {self.recompute_elems} elements")
        if self.order_stats:
            st = self.order_stats
            lines.append(
                f"  order-search: fixed={st.get('fixed_peak')} -> "
                f"joint={st.get('peak')} "
                f"({st.get('order_accepts', 0)} order moves, "
                f"{st.get('placement_moves', 0)} placement moves, "
                f"{st.get('wall_s', 0.0):.1f}s"
                + (", order changed" if st.get("order_changed") else "")
                + ")")
        lines += [f"  | {entry}" for entry in self.log]
        lines.append(self.plan.report())
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Pass registry (register_pass idiom)
# ---------------------------------------------------------------------------

_PASSES: Dict[str, "Pass"] = {}
_PASS_ORDER: List[str] = []


class Pass:
    """A named, individually toggleable pipeline stage."""
    name: str = ""
    default: bool = True

    def run(self, state: PipelineState) -> None:
        raise NotImplementedError


def register_pass(cls):
    """Class decorator: instantiate and add to the pipeline registry in
    declaration order (which is the default execution order)."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"{cls.__name__} must set a pass name")
    if inst.name in _PASSES:
        raise ValueError(f"duplicate pass {inst.name!r}")
    _PASSES[inst.name] = inst
    _PASS_ORDER.append(inst.name)
    return cls


def available_passes() -> Tuple[str, ...]:
    return tuple(_PASS_ORDER)


def default_passes() -> Tuple[str, ...]:
    return tuple(n for n in _PASS_ORDER if _PASSES[n].default)


# ---------------------------------------------------------------------------
# Passes
# ---------------------------------------------------------------------------


@register_pass
class BaselinePass(Pass):
    """Best non-overlapping plan of the *input* graph — the paper's
    "Original" column, and the floor every compiled plan must beat."""
    name = "baseline"

    def run(self, state: PipelineState) -> None:
        state.baseline = P.plan_original(state.original)
        state.log.append(
            f"baseline: {state.baseline.strategy} "
            f"peak={state.baseline.peak_bytes}")


@register_pass
class RemoveConcatsPass(Pass):
    """§II.C operation removal: elide concats whose inputs can write directly
    into the aggregated tensor (branch outputs become views)."""
    name = "remove_concats"

    def run(self, state: PipelineState) -> None:
        g = state.variants[-1][1]
        n = sum(1 for op in g.ops if removable(g, op))
        if not n:
            state.log.append("remove_concats: nothing removable")
            return
        state.variants.append(("remove_concats", remove_concats(g)))
        state.log.append(f"remove_concats: elided {n} concat(s)")


@register_pass
class SplitPass(Pass):
    """§II.A operation splitting, automated and overlap-aware: greedily
    split the peak-defining conv pair into row bands while the planned peak
    improves, evaluating every candidate with the DMO planner so the chosen
    splits are the ones that compose with the diagonal relaxation (banded
    O_s). Applied to the input graph (splitting through aggregated views is
    not defined). ``split="auto"`` skips graphs above ``split_ops_limit`` —
    auto_split re-plans every candidate, which is expensive on the big
    connected graphs where it never fires anyway."""
    name = "split"

    def run(self, state: PipelineState) -> None:
        opt = state.options
        g = state.variants[0][1]
        if opt.split == "off":
            state.log.append("split: disabled")
            return
        if _has_aliases(g):
            # split_pair's tensor remapping resolves aliases to their
            # storage owner, which collapses a reshape's input and output
            # into one self-producing tensor — not a valid rewrite
            state.log.append("split: skipped (aliased tensors)")
            return
        if opt.split == "auto" and len(g.ops) > opt.split_ops_limit:
            state.log.append(
                f"split: skipped ({len(g.ops)} ops > {opt.split_ops_limit})")
            return
        sg, rc, slog = auto_split(g, max_parts=opt.split_max_parts,
                                  method=opt.method, profile=opt.profile)
        if not slog:
            state.log.append("split: no profitable split")
            return
        state.variants.append(("split", sg))
        state.recompute_elems += rc
        state.log += [f"split: {entry}" for entry in slog]


def _has_aliases(g: Graph) -> bool:
    """Any alias (reshape or view) — the split gate: split_pair's tensor
    remapping resolves aliases to their storage owner, which is not a valid
    rewrite (serialisation handles aliases fine since ``serialise._deps``
    became view-aware)."""
    return any(t.alias_of is not None for t in g.tensors)


def _chain_scratch_bytes(g: Graph, members: List[Op]) -> int:
    """Conservative VMEM-scratch estimate for one candidate fused chain:
    the blocked program's packing (chain-internal scratch rows times the
    chain's widest tile-rounded image row) when the chain is dtype-uniform,
    else the flat byte packing. An estimate only — the backend derives the
    exact packing from the legalised layouts at lowering time — but close
    enough to refuse chains no executor could ever launch."""
    internal = {op.output.storage() for op in members[:-1]}
    dbs = {s.dtype_bytes
           for op in members
           for s in [op.output.storage()]
           + [t.storage() for t in op.inputs]
           if s.kind != "weight"}
    if len(dbs) == 1:
        db = next(iter(dbs))
        sub, lanes = P.TPU_TILES.get(db, (8, 128))
        # batched chains stage every image's rows at once (op-major stages)
        _, total = P.fused_slots(
            members, lambda s: int(s.shape[-3]) * s.batch, round_to=sub)
        width = max(int(s.shape[-2]) * int(s.shape[-1]) for s in internal)
        return total * P._round_up(width, lanes) * db
    _, total = P.fused_slots(members, lambda s: s.nbytes,
                             align=max(s.dtype_bytes for s in internal))
    return total


#: The fuse pass's default per-chain scratch budget: the reference's
#: TPU-derived VMEM budget (16 MiB), kept so that plans, winners and fusion
#: decisions equal the reference's. The CUDA fused kernel holds a chain's
#: scratch in shared memory up to 227 KB and in a global buffer above that,
#: so every chain this budget admits runs; a budget derived from Hopper is a
#: later, separately named option.
TPU_FUSE_BUDGET = 16 * 1024 * 1024


@register_pass
class FusePass(Pass):
    """Fused band-chain super-kernels: group each split region's band chain
    (producer bands → consumer bands → the reassembling concat, recovered
    from the ``split_src``/``band_pad`` provenance SplitPass stamps) into a
    fused unit the kernel layer lowers to ONE kernel whose chain-internal
    tensors live in kernel scratch. The fused variant re-kinds those tensors
    to ``scratch`` so they drop out of arena placement entirely — the
    planned banded peak falls below the O_s-only split peak. Chains whose
    estimated scratch exceeds the VMEM budget are left unfused (no executor
    could launch them); the plain split variant always remains a planning
    candidate."""
    name = "fuse"

    def run(self, state: PipelineState) -> None:
        opt = state.options
        if opt.fuse == "off":
            state.log.append("fuse: disabled")
            return
        from repro_torch.core.splitting import find_band_chains, fuse_chains
        for label, g in list(state.variants):
            if label != "split":
                continue
            chains = find_band_chains(g)
            if not chains:
                state.log.append("fuse: no fusable band chains")
                continue
            budget = self._budget(opt)
            keep: List[List[Op]] = []
            skipped = 0
            for ch in chains:
                est = _chain_scratch_bytes(g, ch)
                if est <= budget:
                    keep.append(ch)
                else:
                    skipped += 1
                    state.log.append(
                        f"fuse: chain {ch[-1].name!r} refused — estimated "
                        f"scratch {est} bytes exceeds the {budget}-byte "
                        "VMEM budget (left unfused)")
            if not keep:
                continue
            fg = fuse_chains(g, keep)
            if fg is None:
                continue
            n_members = sum(len(ch) for ch in keep)
            state.variants.append(("fuse", fg))
            state.log.append(
                f"fuse: {len(keep)} chain(s), {n_members} band ops -> "
                f"{len(keep)} fused kernel(s)"
                + (f"; {skipped} over-budget chain(s) left unfused"
                   if skipped else ""))

    @staticmethod
    def _budget(opt: CompileOptions) -> int:
        if opt.fuse_vmem_budget is not None:
            return int(opt.fuse_vmem_budget)
        env = os.environ.get("REPRO_DMO_VMEM_BUDGET", "").strip()
        if env:
            return int(env)
        return TPU_FUSE_BUDGET


@register_pass
class SerialisePass(Pass):
    """§II.B: candidate execution orders (eager / lazy / memory-greedy) per
    variant; the plan pass keeps the best plan over all of them. Since
    ``serialise._deps`` became view-aware, concat-removal variants (whose
    branch ops write into aggregated views) are reordered too instead of
    pinning construction order."""
    name = "serialise"

    def run(self, state: PipelineState) -> None:
        for i, (label, g) in enumerate(state.variants):
            if order_pinned(g):
                # a fused chain's members must stay contiguous in execution
                # order (one kernel per chain, stage weights consecutive) —
                # fused variants keep construction order
                state.log.append(f"serialise[{label}]: skipped "
                                 "(fused chains pin the order)")
                continue
            orders = candidate_orders(g)
            if len(orders) > 1:
                state.orders[i] = orders
                state.log.append(f"serialise[{label}]: {len(orders)} "
                                 "candidate orders")


def _fixed_plan_grid(state: PipelineState) -> List[Tuple[str, P.Plan]]:
    """plan_dmo over every (variant, order) pair — the fixed-order candidate
    grid both OrderSearchPass and PlanPass rank. The non-overlapping
    baseline of the input graph is itself a candidate, so the eventual
    winner is never worse than it."""
    opt = state.options
    cands: List[Tuple[str, P.Plan]] = []
    if state.baseline is not None:
        cands.append(("input", state.baseline))
    for i, (label, g) in enumerate(state.variants):
        # construction order is always a candidate (None); serialise orders
        # augment it, minus exact duplicates
        orders = [None] + [o for o in state.orders.get(i, [])
                           if list(o) != list(g.ops)]
        for order in orders:
            cands.append((label, P.plan_dmo(
                g, order, method=opt.method, profile=opt.profile)))
    return cands


@register_pass
class OrderSearchPass(Pass):
    """Joint execution-order x overlap search (beyond-paper): ILS over the
    product of dependency-respecting linearisations (``serialise.OrderMoves``
    legality, seeded from the serialise heuristics) and insertion-order
    placement, under the same wall budget the placement-only refinement used
    to get. Runs on the *winning* variant of the fixed-order grid — so split
    variants re-enter the joint search whenever splitting wins, while fused
    variants search placement only (chains pin their order). The fixed-order
    candidates stay in ``state.fixed_plans`` as PlanPass's guaranteed
    fallback: order search can never regress a model."""
    name = "order_search"

    def run(self, state: PipelineState) -> None:
        opt = state.options
        if opt.order_search == "off":
            state.log.append("order_search: disabled")
            return
        budget = (auto_budget_s(state.original)
                  if opt.budget_s == "auto" else float(opt.budget_s))
        if budget <= 0 and opt.order_search == "on":
            budget = 1.0  # forced on: minimal search budget
        if budget <= 0:
            state.log.append("order_search: skipped (no search budget)")
            return
        state.fixed_plans = _fixed_plan_grid(state)
        label, fixed = min(state.fixed_plans, key=lambda c: c[1].peak_bytes)
        g = fixed.graph
        vi = next((i for i, (_, vg) in enumerate(state.variants)
                   if vg is g), 0)
        pinned = order_pinned(g)
        seeds = [list(fixed.order), list(g.ops)] + \
            [list(o) for o in state.orders.get(vi, [])]
        plan, stats = P.plan_joint(
            g, seeds, method=opt.method, profile=opt.profile,
            budget_s=budget, seed=opt.seed,
            allow_order_moves=not pinned)
        stats["fixed_peak"] = fixed.peak_bytes
        stats["budget_s"] = budget
        state.joint = (label, plan)
        state.order_stats = stats
        state.log.append(
            f"order_search: joint ILS ({budget:.1f}s"
            f"{', autoscaled' if opt.budget_s == 'auto' else ''}) on "
            f"{label}: fixed={fixed.peak_bytes} -> joint={plan.peak_bytes}"
            + (" [order pinned: placement moves only]" if pinned else
               f" [{stats['order_accepts']} order moves accepted"
               + (", winning order changed" if stats["order_changed"]
                  else "") + "]"))


@register_pass
class PlanPass(Pass):
    """DMO planning over every (variant, order) pair; keeps the lowest-peak
    plan. The baseline is itself a candidate, so the result is never worse
    than the non-overlapping plan of the input graph. Split variants plan
    with the full relaxation like every other variant — band ops carry
    their own banded O_s (explicit band pads), which is how splitting and
    diagonal overlap compose. ``budget_s > 0`` adds an ILS ``plan_search``
    refinement on the winning variant."""
    name = "plan"

    def run(self, state: PipelineState) -> None:
        opt = state.options
        # fixed-order grid: reuse OrderSearchPass's if it ran (nothing is
        # planned twice), else compute it here
        cands = (list(state.fixed_plans) if state.fixed_plans is not None
                 else _fixed_plan_grid(state))
        if state.joint is not None:
            # the joint search's winner competes as one more candidate; on a
            # tie min() keeps the earlier fixed-order plan, which is exactly
            # the never-regress fallback to the serialised order
            cands.append(state.joint)
        label, best = min(cands, key=lambda c: c[1].peak_bytes)
        budget = (auto_budget_s(state.original)
                  if opt.budget_s == "auto" else opt.budget_s)
        if budget > 0 and state.joint is None:
            # order_search off/skipped: the historical placement-only ILS
            # refinement of the winning fixed order
            sp = P.plan_search(best.graph, best.order,
                               method=opt.method, budget_s=budget,
                               seed=opt.seed, profile=opt.profile)
            state.log.append(
                f"plan: ILS search ({budget:.1f}s"
                f"{', autoscaled' if opt.budget_s == 'auto' else ''}) "
                f"-> {sp.peak_bytes}")
            if sp.peak_bytes < best.peak_bytes:
                best = sp
        state.plan, state.winner = best, label
        state.log.append(
            f"plan: {len(cands)} candidate(s), best={best.strategy} "
            f"on {label}, peak={best.peak_bytes}")


#: Numeric verification replays every op row-by-row in NumPy — cap the work.
#: Above the reference's 300,000 so that the paper's flagship (its fused
#: graph holds 397,520 arena elements, about a second of NumPy replay) is
#: verified numerically, on the card too under ``backend="cuda"``; plans do
#: not depend on it.
_NUMERIC_ELEM_LIMIT = 500_000


def _numeric_verifiable(g: Graph) -> bool:
    if X.executability(g) is not None:
        return False
    return sum(t.elems for t in g.arena_tensors()) <= _NUMERIC_ELEM_LIMIT


@register_pass
class VerifyPass(Pass):
    """Plan safety: always the formal no-clobber constraint check; plus the
    bit-exact arena-vs-private-buffers execution (:func:`verify_plan`) when
    the winning graph is executable by the NumPy arena interpreter
    (``verify="numeric"`` forces it and raises when it is not). A winning
    *split* variant is additionally cross-checked against its **unsplit**
    reference — band ops share the source op's weights and calibration, so
    the banded execution must reproduce the original graph's outputs.
    Compiling for the ``cuda`` backend adds a further tier: the plan is
    executed by the cuda backend's flat program on the card and
    cross-checked output-for-output against the numpy arena execution (fp32
    tolerance where the kernels sum in another order, <= 1 LSB on int8)."""
    name = "verify"

    def run(self, state: PipelineState) -> None:
        if state.plan is None or state.options.verify == "off":
            return
        state.plan.validate()
        state.verified = "constraints"
        mode = state.options.verify
        if mode == "constraints":
            return
        if not _numeric_verifiable(state.plan.graph):
            if mode == "numeric":
                raise ValueError(
                    "verify='numeric' requested but the winning graph is not "
                    "executable by the arena interpreter (unsupported op "
                    "kind, aggregated views, unsupported arena dtype, or "
                    "too large)")
            state.log.append("verify: constraints only (graph not "
                             "numerically executable)")
            return
        # one reference + one numpy arena execution serve both tiers: the
        # bit-exact numeric check here, and (for backend="cuda") the
        # cross-check below against the same data — no redundant runs.
        # int8 graphs calibrate once (a float reference run) and share the
        # QuantSpec across the reference and every backend.
        opt = state.options
        g = state.plan.graph
        weights = X.synth_weights(g, opt.seed)
        quant = (X.calibrate(g, opt.seed, weights)
                 if X.needs_quant(g) else None)
        inputs = (X.quant_inputs(g, quant, opt.seed) if quant is not None
                  else X.random_inputs(g, opt.seed))
        ref = run_reference(g, inputs, state.plan.order, weights=weights,
                            quant=quant)
        got_np = X.get_backend("numpy").execute(state.plan, inputs, weights,
                                                quant=quant)
        X.compare_outputs(ref, got_np, exact=True, label="numpy arena")
        state.verified = "numeric"
        state.log.append("verify: arena execution bit-exact"
                         + (" (int8 quantised tier)" if quant else ""))
        if state.winner in ("split", "fuse") and g is not state.original \
                and _numeric_verifiable(state.original):
            # split (and fused-split) graphs compute the same network as
            # their unsplit reference (band ops share the source op's
            # weight draw, and calibration pools band ranges — fusion only
            # re-kinds chain internals to scratch, same op sequence), so
            # the arena execution must reproduce the *original* graph's
            # outputs too: f32 bit-exact (band arithmetic replays the
            # reference loop order), int8 to <= 1 LSB (a valid-padded pair
            # can leave intermediate rows no band recomputes, nudging the
            # pooled calibration range)
            w0 = X.synth_weights(state.original, opt.seed)
            q0 = (X.calibrate(state.original, opt.seed, w0)
                  if X.needs_quant(state.original) else None)
            in0 = (X.quant_inputs(state.original, q0, opt.seed)
                   if q0 is not None
                   else X.random_inputs(state.original, opt.seed))
            ref0 = run_reference(state.original, in0, weights=w0, quant=q0)
            X.compare_outputs(ref0, got_np, exact=(quant is None),
                              label="split bands vs unsplit reference")
            state.log.append(
                "verify: split-band execution matches the unsplit "
                "reference" + (" (<= 1 LSB)" if quant else " (bit-exact)"))
        if opt.backend == "cuda":
            # the flat byte program through the hand-written kernels, on the
            # card (the default device of the cuda backend)
            got_cu = X.get_backend("cuda").execute(
                state.plan, inputs, weights, quant=quant)
            X.compare_outputs(got_np, got_cu, exact=False,
                              label="cuda flat vs numpy")
            state.verified = "numeric+cuda"
            state.log.append("verify: cuda arena execution matches numpy "
                             "backend (flat)")


# ---------------------------------------------------------------------------
# The entrypoint + plan cache (memory tier + optional content-addressed disk
# tier, so benchmark reruns start warm across processes)
# ---------------------------------------------------------------------------

_PLAN_CACHE: Dict[Tuple[str, str], CompiledPlan] = {}
_CACHE_STATS = {"hits": 0, "misses": 0, "disk_hits": 0, "disk_misses": 0}
#: Incremented once per actual pipeline execution (never on a cache hit).
PIPELINE_RUNS = 0
#: Part of the disk key (with the source fingerprint below): a key collision
#: with an older build would silently serve stale plans to benchmark reruns.
_DISK_SCHEMA = "v1"
_CODE_FINGERPRINT: Optional[str] = None


def _code_version() -> str:
    """Content hash of the planning code (repro/core + overlap sources),
    folded into the disk-cache key so ANY planner/pass-chain edit — released
    or just saved in a dev checkout — invalidates persisted plans instead of
    serving results computed by old code."""
    global _CODE_FINGERPRINT
    if _CODE_FINGERPRINT is None:
        h = hashlib.sha256()
        root = pathlib.Path(__file__).resolve().parent
        try:
            for p in sorted(root.rglob("*.py")):
                h.update(p.name.encode())
                h.update(p.read_bytes())
        except OSError:
            pass  # zip/frozen installs: schema tag still guards
        _CODE_FINGERPRINT = h.hexdigest()[:16]
    return _CODE_FINGERPRINT


def _disk_cache_dir() -> pathlib.Path:
    # its own directory and variable: pickles of one package are never
    # served to the other
    return pathlib.Path(os.environ.get(
        "REPRO_DMO_TORCH_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "repro-dmo-torch")))


def _disk_enabled(explicit: Optional[bool]) -> bool:
    if explicit is not None:
        return explicit
    return os.environ.get("REPRO_DMO_DISK_CACHE", "").lower() in (
        "1", "true", "yes", "on")


def _disk_path(key: Tuple[str, str]) -> pathlib.Path:
    h = hashlib.sha256(
        f"{_DISK_SCHEMA}:{_code_version()}:{key[0]}:{key[1]}".encode())
    return _disk_cache_dir() / f"{h.hexdigest()}.pkl"


def _disk_load(key: Tuple[str, str]) -> Optional[CompiledPlan]:
    path = _disk_path(key)
    try:
        with open(path, "rb") as f:
            entry = pickle.load(f)
    except Exception:
        # any unreadable/stale entry (corrupt file, renamed classes from an
        # un-bumped schema, ...) must degrade to a cold miss, never crash
        _CACHE_STATS["disk_misses"] += 1
        return None
    if not isinstance(entry, CompiledPlan):
        _CACHE_STATS["disk_misses"] += 1
        return None
    _CACHE_STATS["disk_hits"] += 1
    return entry


def _disk_store(key: Tuple[str, str], entry: CompiledPlan) -> None:
    path = _disk_path(key)
    tmp = path.with_suffix(f".tmp.{os.getpid()}")
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(tmp, "wb") as f:
            pickle.dump(entry, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)  # atomic: concurrent benchmark shards race here
    except Exception:
        # a cold cache is never an error — unpicklable op params (free-form
        # dicts), full disks, permissions: all degrade to not-persisted
        try:
            tmp.unlink(missing_ok=True)
        except OSError:
            pass


def cache_info() -> Dict[str, Any]:
    return {"size": len(_PLAN_CACHE), "disk_dir": str(_disk_cache_dir()),
            **_CACHE_STATS}


def cache_clear(disk: bool = False) -> None:
    """Clear the in-memory tier and reset counters; ``disk=True`` also
    deletes the persisted entries under the disk cache dir."""
    _PLAN_CACHE.clear()
    for k in _CACHE_STATS:
        _CACHE_STATS[k] = 0
    if disk:
        try:
            # *.tmp.<pid> are orphans of interrupted _disk_store writes
            for pattern in ("*.pkl", "*.tmp.*"):
                for p in _disk_cache_dir().glob(pattern):
                    p.unlink(missing_ok=True)
        except OSError:
            pass


def compile(graph: Graph, *, profile: str = "paper",
            method: str = "algorithmic", budget_s: Union[float, str] = 0.0,
            seed: int = 0, order_search: str = "auto",
            passes: Optional[Sequence[str]] = None,
            split: str = "auto", split_max_parts: int = 8,
            split_ops_limit: int = 150, fuse: str = "auto",
            fuse_vmem_budget: Optional[int] = None, verify: str = "auto",
            backend: str = "numpy", batch: int = 1, cache: bool = True,
            disk_cache: Optional[bool] = None) -> CompiledPlan:
    """Compile ``graph`` to an arena plan through the registered pass chain.

    Args:
        graph: tensor-op graph (see :mod:`repro_torch.core.graph`).
        profile: overlap profile — ``"paper"`` (only the op kinds the paper
            derives O_s for) or ``"extended"``.
        method: O_s calculator (``analytic``/``algorithmic``/``trace``/``auto``).
        budget_s: wall-clock budget for the ILS search refinement (0 = off,
            fully deterministic pipeline), or ``"auto"`` to derive the budget
            from the graph's op/tensor count (:func:`auto_budget_s`).
        seed: RNG seed for every stochastic search stage (the joint order
            search and plan_search). Part of the plan-cache key: a cached
            plan is never returned for different search settings.
        order_search: joint execution-order x overlap search mode —
            ``"auto"`` runs the joint ILS over (linearisation, placement)
            whenever a search budget is set, ``"on"`` forces it (1 s floor
            budget), ``"off"`` restores the placement-only ILS refinement
            of the fixed serialised order.
        passes: pass names to run, in order (default:
            :func:`default_passes`). Unknown names raise.
        split: operation-splitting mode (``auto``/``on``/``off``);
            ``split_ops_limit`` is the op-count gate for ``auto``.
        fuse: band-chain fusion mode (``auto``/``on``/``off``): group each
            split region's band chain into one fused super-kernel whose
            intermediates live in kernel scratch instead of the arena.
            ``fuse_vmem_budget`` (bytes) overrides the per-chain scratch
            gate (default: ``REPRO_DMO_VMEM_BUDGET`` env, else 16 MiB);
            over-budget chains are left unfused.
        verify: verification mode (``auto``/``constraints``/``numeric``/``off``).
        batch: leading batch axis to compile the plan for (default 1). The
            graph is rewritten through :func:`repro_torch.core.graph.with_batch`
            before any pass runs; every pass, the planner, the legaliser and
            the verify tiers then operate on the batched graph, and the
            batch is folded into the plan-cache key (memory + disk).
        backend: executor backend the plan is compiled for (``"numpy"`` or
            ``"cuda"``); ``"cuda"`` adds a verify tier that runs the flat
            byte program through the CUDA kernels on the card and
            cross-checks it against the numpy backend (``verified ==
            "numeric+cuda"``), and ``CompiledPlan.execute()`` runs on this
            backend by default.
        cache: look up / populate the content-addressed plan cache.
        disk_cache: persist/look up plans on disk under
            ``$REPRO_DMO_TORCH_CACHE_DIR`` (default
            ``~/.cache/repro-dmo-torch``) so
            reruns in fresh processes start warm. ``None`` defers to the
            ``REPRO_DMO_DISK_CACHE`` env toggle (default off).
            ``cache=False`` disables both tiers; combining it with an
            explicit ``disk_cache=True`` raises.

    Returns:
        A :class:`CompiledPlan`. Cache hits return the memoised result
        (``cache_hit=True``) without re-running any pass — its graph/plan
        objects belong to the first structurally identical compile (see the
        :class:`CompiledPlan` cache-hit note).
    """
    if profile not in ("paper", "extended"):
        raise ValueError(f"unknown overlap profile {profile!r} "
                         "(expected 'paper' or 'extended')")
    if method not in ("auto", "analytic", "algorithmic", "trace"):
        raise ValueError(f"unknown O_s method {method!r}")
    if split not in ("auto", "on", "off"):
        raise ValueError(f"unknown split mode {split!r}")
    if fuse not in ("auto", "on", "off"):
        raise ValueError(f"unknown fuse mode {fuse!r}")
    if verify not in ("auto", "constraints", "numeric", "off"):
        raise ValueError(f"unknown verify mode {verify!r}")
    if order_search not in ("auto", "on", "off"):
        raise ValueError(f"unknown order_search mode {order_search!r}")
    if backend not in X.available_backends():
        raise ValueError(f"unknown executor backend {backend!r}; "
                         f"available: {X.available_backends()}")
    if budget_s != "auto" and not (isinstance(budget_s, (int, float))
                                   and not isinstance(budget_s, bool)
                                   and budget_s >= 0):
        raise ValueError(f"budget_s must be >= 0 or 'auto', got {budget_s!r}")
    if disk_cache and not cache:
        raise ValueError("disk_cache=True requires cache=True "
                         "(cache=False disables all caching)")
    if not isinstance(batch, int) or isinstance(batch, bool) or batch < 1:
        raise ValueError(f"batch must be an int >= 1, got {batch!r}")
    if batch > 1:
        from repro_torch.core.graph import with_batch
        graph = with_batch(graph, batch)
    opts = CompileOptions(profile=profile, method=method, budget_s=budget_s,
                          seed=seed, order_search=order_search, split=split,
                          split_max_parts=split_max_parts,
                          split_ops_limit=split_ops_limit, fuse=fuse,
                          fuse_vmem_budget=fuse_vmem_budget, verify=verify,
                          backend=backend, batch=batch)
    names = tuple(passes) if passes is not None else default_passes()
    unknown = [n for n in names if n not in _PASSES]
    if unknown:
        raise ValueError(f"unknown pass(es) {unknown}; "
                         f"available: {available_passes()}")
    t0 = time.perf_counter()
    key = (graph_signature(graph), opts.key() + repr(names))
    use_disk = cache and _disk_enabled(disk_cache)
    if cache and key in _PLAN_CACHE:
        _CACHE_STATS["hits"] += 1
        entry = _PLAN_CACHE[key]
        if use_disk and not _disk_path(key).exists():
            _disk_store(key, entry)  # explicit persist of a warm entry
        return dataclasses.replace(entry, cache_hit=True,
                                   log=list(entry.log),
                                   compile_s=time.perf_counter() - t0)
    _CACHE_STATS["misses"] += 1
    if use_disk:
        entry = _disk_load(key)
        if entry is not None:
            _PLAN_CACHE[key] = entry
            return dataclasses.replace(entry, cache_hit=True,
                                       log=list(entry.log),
                                       compile_s=time.perf_counter() - t0)

    global PIPELINE_RUNS
    PIPELINE_RUNS += 1
    state = PipelineState(original=graph, options=opts,
                          variants=[("input", graph)])
    for n in names:
        _PASSES[n].run(state)
    if state.plan is None:  # "plan" not in the chain: fall back to baseline
        if state.baseline is None:
            state.baseline = P.plan_original(graph)
        state.plan = state.baseline
        state.winner = "input"
        if "verify" in names:  # honour the verify contract for the fallback
            _PASSES["verify"].run(state)
    if state.baseline is None:
        state.baseline = state.plan
    result = CompiledPlan(
        original=graph, graph=state.plan.graph, plan=state.plan,
        baseline=state.baseline, passes=names, log=state.log, key=key[0],
        winner=state.winner, verified=state.verified,
        recompute_elems=(state.recompute_elems
                         if state.winner in ("split", "fuse") else 0),
        compile_s=time.perf_counter() - t0, backend=backend,
        order_stats=state.order_stats)
    if cache:
        _PLAN_CACHE[key] = result
        if use_disk:
            _disk_store(key, result)
        # hand out a copy of the mutable log so caller edits can't poison
        # the cached entry (the hit path copies symmetrically)
        return dataclasses.replace(result, log=list(result.log))
    return result


# ---------------------------------------------------------------------------
# Batch sweeps + multi-process compilation (the serving-runtime front door)
# ---------------------------------------------------------------------------


def peak_vs_batch(graph: Graph, batches: Sequence[int] = (1, 2, 4, 8),
                  **compile_kwargs) -> List[Dict[str, Any]]:
    """Compile ``graph`` at every batch in ``batches`` and tabulate the
    memory-vs-batch trade curve a server picks its batch variant from. Each
    compile runs the full pass chain — ``Plan.validate`` re-checks the
    no-clobber constraints at every swept batch — and hits the plan cache on
    reruns. Returns one row per batch: byte peak, per-image peak, padded
    (row-blocked) peak when the plan legalises, and the ratio to ``batch *
    peak(1)``. The ratio is <= 1.0 whenever batch 1 and batch b compile
    the same graph variant (the scaled batch-1 candidate inside
    ``plan_dmo`` guarantees it); it can exceed 1.0 slightly when the VMEM
    budget refuses a fused chain only at the larger batch (batched scratch
    is b x bigger), forcing the bands back into the arena — e.g.
    mobilenet_v2_1.0_224 at batch 8 (+2.5%)."""
    rows: List[Dict[str, Any]] = []
    peak1: Optional[int] = None
    for b in sorted(set(int(x) for x in batches)):
        cp = compile(graph, batch=b, **compile_kwargs)
        if b == 1:
            peak1 = cp.peak_bytes
        bp = cp.legalised()
        rows.append({
            "batch": b,
            "peak_bytes": cp.peak_bytes,
            "per_image_bytes": -(-cp.peak_bytes // b),
            "baseline_bytes": cp.baseline_bytes,
            "saving_pct": round(cp.saving_pct, 2),
            "padded_peak_bytes": (bp.padded_peak_bytes
                                  if bp is not None else None),
            "peak_ratio_vs_b1": (round(cp.peak_bytes / (b * peak1), 4)
                                 if peak1 else None),
            "verified": cp.verified,
        })
    return rows


def _compile_many_worker(job: Tuple[Graph, int, Dict[str, Any]]
                         ) -> Dict[str, Any]:
    """One (graph, batch) compile in a worker process. Module-level (spawn
    pickling); reports per-job disk-cache deltas so the parent can prove
    cross-process sharing."""
    graph, batch, kwargs = job
    before = dict(_CACHE_STATS)
    t0 = time.perf_counter()
    cp = compile(graph, batch=batch, **kwargs)
    return {
        "graph": graph.name,
        "batch": batch,
        "peak_bytes": cp.peak_bytes,
        "baseline_bytes": cp.baseline_bytes,
        "saving_pct": round(cp.saving_pct, 2),
        "verified": cp.verified,
        "cache_hit": cp.cache_hit,
        "disk_hits": _CACHE_STATS["disk_hits"] - before["disk_hits"],
        "disk_misses": _CACHE_STATS["disk_misses"] - before["disk_misses"],
        "wall_s": round(time.perf_counter() - t0, 4),
    }


def compile_many(graphs: Sequence[Graph], batches: Sequence[int] = (1,),
                 workers: int = 2, **compile_kwargs) -> List[Dict[str, Any]]:
    """Fan the ``graphs x batches`` compile grid across ``workers``
    processes sharing the content-addressed disk plan-cache (process-safe:
    :func:`_disk_store` writes via temp file + atomic ``os.replace``, so
    concurrent writers of one key race benignly to an identical entry).

    ``disk_cache=True`` is the default here — it is the only channel worker
    processes share results through; pass ``disk_cache=False`` to measure
    cold compiles. ``workers <= 1`` runs inline (no subprocess), which the
    deterministic tests use. Returns one picklable summary dict per (graph,
    batch) job, in grid order."""
    kwargs = dict(compile_kwargs)
    kwargs.setdefault("disk_cache", True)
    jobs = [(g, int(b), kwargs) for g in graphs for b in batches]
    if workers <= 1:
        return [_compile_many_worker(j) for j in jobs]
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with ctx.Pool(processes=min(workers, len(jobs) or 1)) as pool:
        return pool.map(_compile_many_worker, jobs)
