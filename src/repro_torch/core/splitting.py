"""Operation splitting (paper §II.A) — automated, overlap-aware.

A pair of conv-family ops with a large intermediate can be split into
``parts`` row bands executed sequentially: each band recomputes a small halo
of the intermediate but the full intermediate never exists at once. The
paper demonstrates this manually on MobileNet v1 (96 → 66 KB, 6144 elements
recomputed) and calls automating it future work; :func:`auto_split` is that
automation — it repeatedly splits the peak-defining pair while the planned
peak improves, accounting the recompute penalty.

Band semantics: every band op carries

- ``row_range=(r0, r1)`` — the output rows of its reference op it computes
  (band-local after re-splitting an already-banded op);
- ``band_pad=(ph, pw)`` — the *explicit* leading pads of the band-local
  loop nest (:func:`repro_torch.core.graph.op_pads`): output-local row ``o``
  reads input-local rows ``o*sh - ph + fy*dh``. A consumer band's ``ph``
  is its share of the pair's SAME padding (``ph`` rows on the first band,
  0 once the halo starts inside the intermediate); a producer band's
  ``ph`` is *negative* — its output rows start ``m0*sh - ph`` rows deep in
  the full input it reads. Carrying the pads explicitly (instead of the
  old ``padding="valid"`` re-labelling) is what keeps the edge bands'
  declared shapes consistent under SAME padding — the valid-conv reading
  made the first/last bands ``ph`` rows short;
- ``split_src=<op name>`` — weight/calibration provenance: all bands of
  one reference op share its weight draw and pool their activation ranges
  (:func:`repro_torch.core.exec.ops.synth_weights` /
  :func:`~repro_torch.core.exec.ops.calibrate`), so a split graph computes the
  *same network* as its unsplit reference, band for band.

With those params a band is an ordinary conv/pool over its band shapes, so
the O_s calculators, the executor backends and the row-blocked legaliser
all handle bands through the one shared geometry helper — splitting and
diagonal overlap compose (the paper's §II.A + §III future-work item), and
:func:`auto_split` evaluates candidates with the overlap-aware planner.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.graph import Graph, Op, Tensor, op_pads
from repro_torch.core.planner import plan_dmo, plan_original

_SPLITTABLE = ("conv2d", "depthwise_conv2d", "pool")

#: Op kinds a fused band-chain super-kernel can run as an in-VMEM stage
#: (the kinds `_BODIES` implements over the routed memory layer).
FUSABLE_KINDS = ("conv2d", "depthwise_conv2d", "pool", "elementwise",
                 "concat")


def _rows_needed(op: Op, o0: int, o1: int) -> Tuple[int, int]:
    """Input row range feeding output rows [o0, o1) of a conv-family op
    (band-local when ``op`` is itself already banded)."""
    ih = op.inputs[0].shape[0]
    kh = op.params["kernel"][0]
    sh = op.params.get("stride", (1, 1))[0]
    dh = op.params.get("dilation", (1, 1))[0]
    ph = op_pads(op)[0]
    lo = max(0, o0 * sh - ph)
    hi = min(ih, (o1 - 1) * sh - ph + (kh - 1) * dh + 1)
    return lo, hi


def split_pair(g: Graph, ia: int, parts: int
               ) -> Optional[Tuple[Graph, int]]:
    """Split ops (ia, ia+1) into ``parts`` row-band pairs.

    Returns (new graph, recomputed intermediate elements), or None if the
    pair is not splittable (wrong kinds, intermediate multiply consumed...).
    """
    ops = g.ops
    if ia < 0 or ia + 1 >= len(ops):
        return None
    a, b = ops[ia], ops[ia + 1]
    if a.kind not in _SPLITTABLE or b.kind not in _SPLITTABLE:
        return None
    mid = a.output.storage()
    consumers = [op for op in ops if mid in
                 [t.storage() for t in op.inputs]]
    if consumers != [b] or b.inputs[0].storage() is not mid:
        return None
    oh_b = b.output.shape[0]
    if oh_b < parts or oh_b % parts:
        return None

    ng = Graph(g.name + f"_split{ia}x{parts}")
    ng.batch = g.batch
    mapping = {}

    def map_t(t: Tensor) -> Tensor:
        s = t.storage()
        if s not in mapping:
            mapping[s] = ng.tensor(s.name, s.shape, s.dtype_bytes, s.kind)
        return mapping[s]

    ph_a, pw_a = op_pads(a)
    ph_b, pw_b = op_pads(b)
    sh_a = a.params.get("stride", (1, 1))[0]
    sh_b = b.params.get("stride", (1, 1))[0]
    # re-splitting an already-banded op keeps the *reference* op's
    # weight/calibration group, so sub-bands still share its draw
    src_a = a.params.get("split_src", a.name)
    src_b = b.params.get("split_src", b.name)
    band = oh_b // parts
    halo_rows = 0      # intermediate rows produced across all bands
    covered_hi = None  # union of the bands' halo row ranges (they ascend)
    covered = 0
    for i, op in enumerate(ops):
        if i == ia:
            continue
        if i == ia + 1:
            t0 = map_t(a.inputs[0])
            pieces = []
            w_mid, c_mid = a.output.shape[1], a.output.shape[2]
            for p in range(parts):
                o0, o1 = p * band, (p + 1) * band
                m0, m1 = _rows_needed(b, o0, o1)
                if m1 <= m0:
                    return None  # a band reading pure padding: degenerate
                mid_p = ng.tensor(f"{mid.name}_p{p}",
                                  (m1 - m0, w_mid, c_mid), mid.dtype_bytes)
                ng.add(Op(a.kind, [t0], [mid_p],
                          dict(a.params, row_range=(m0, m1),
                               band_pad=(ph_a - m0 * sh_a, pw_a),
                               split_src=src_a),
                          f"{a.name}_p{p}"))
                out_p = ng.tensor(f"{b.output.name}_p{p}",
                                  (o1 - o0, *b.output.shape[1:]),
                                  b.output.dtype_bytes)
                ng.add(Op(b.kind, [mid_p], [out_p],
                          dict(b.params, row_range=(o0, o1),
                               band_pad=(ph_b + m0 - o0 * sh_b, pw_b),
                               split_src=src_b),
                          f"{b.name}_p{p}"))
                pieces.append(out_p)
                halo_rows += m1 - m0
                covered += m1 - max(m0, covered_hi if covered_hi is not None
                                    else m0)
                covered_hi = m1
            out = map_t(b.output)
            ng.add(Op("concat", pieces, [out], dict(axis=0),
                      f"{b.name}_cat"))
            continue
        new_ins = [map_t(t) for t in op.inputs]
        new_outs = [map_t(t) for t in op.outputs]
        ng.add(Op(op.kind, new_ins, new_outs, dict(op.params), op.name))
    # recompute = rows produced more than once (the bands' halo total minus
    # the union of rows they cover — NOT minus the full intermediate, which
    # over-credited rows no band ever produces, e.g. a valid-padded pair's
    # bottom leftover rows)
    recompute = (halo_rows - covered) * a.output.shape[1] * a.output.shape[2]
    return ng, max(0, recompute)


def _is_band(op: Op) -> bool:
    """A row band produced by :func:`split_pair`: conv-family op carrying
    the explicit band provenance params."""
    return (op.kind in _SPLITTABLE and "row_range" in op.params
            and "band_pad" in op.params and "split_src" in op.params)


def find_band_chains(g: Graph) -> List[List[Op]]:
    """Discover fusable band chains in a split graph.

    A chain is the whole split region of :func:`split_pair`: every producer
    band, every consumer band, and the axis-0 concat that reassembles them —
    discovered backwards from each concat through band provenance. A chain
    qualifies for fusion only when its internal tensors (every member output
    except the concat's) are consumed exclusively inside the chain (so they
    can become VMEM scratch, invisible to the arena) and the members sit
    contiguously in graph order ending at the concat (so the fused kernel
    replaces a contiguous run of ops and the surrounding execution order is
    untouched). Returns chains as member-op lists in graph order, concat
    last.
    """
    producers: Dict[Tensor, Op] = {}
    consumers: Dict[Tensor, List[Op]] = {}
    index: Dict[int, int] = {}
    for i, op in enumerate(g.ops):
        index[id(op)] = i
        for t in op.outputs:
            producers[t.storage()] = op
        for t in op.inputs:
            s = t.storage()
            if s.kind != "weight":
                consumers.setdefault(s, []).append(op)
    aliased = {t.alias_of.storage() for t in g.tensors
               if t.alias_of is not None}
    chains: List[List[Op]] = []
    for cat in g.ops:
        if cat.kind != "concat" or cat.params.get("axis", -1) != 0:
            continue
        # transitive closure of band producers behind the concat
        members: Dict[int, Op] = {id(cat): cat}
        frontier = [t.storage() for t in cat.inputs]
        while frontier:
            s = frontier.pop()
            p = producers.get(s)
            if p is None or not _is_band(p) or id(p) in members:
                continue  # external chain input: stays in the arena
            members[id(p)] = p
            frontier.extend(t.storage() for t in p.inputs
                            if t.storage().kind != "weight")
        if len(members) < 3:  # at least one producer/consumer band pair
            continue
        internal = {t.storage() for op in members.values() if op is not cat
                    for t in op.outputs}
        idxs = sorted(index[id(op)] for op in members.values())
        if not (
            # contiguous run ending at the concat
            idxs == list(range(idxs[0], idxs[-1] + 1))
            and idxs[-1] == index[id(cat)]
            and all(op.kind in FUSABLE_KINDS for op in members.values())
            # internal tensors: chain-private, unaliased plain intermediates
            and all(s.kind == "intermediate" and s.alias_of is None
                    and s not in aliased
                    and all(id(c) in members for c in consumers.get(s, []))
                    for s in internal)
            # in-VMEM stages need batch-1 HWC geometry (the scratch buffer
            # is a rows x rowlen 2-D block, one image row per scratch row)
            and all(len(s.shape) == 3 for s in internal)
        ):
            continue
        chains.append([g.ops[i] for i in idxs])
    return chains


def fuse_chains(g: Graph, chains: Optional[List[List[Op]]] = None
                ) -> Optional[Graph]:
    """Rebuild ``g`` with each band chain marked for fused execution.

    Chain-internal tensors are re-kinded ``"scratch"`` — they drop out of
    :meth:`Graph.arena_tensors`/:meth:`Graph.scopes` and therefore out of
    arena placement entirely — and every member op gains
    ``fuse_chain=<concat name>`` / ``fuse_stage=<k>`` params, which the
    Pallas layer uses to emit ONE kernel per chain (stage order = graph
    order). Op sequence, kinds, names and numeric semantics are unchanged,
    so weight synthesis and calibration stay position-for-position aligned
    with the unfused graph. Returns ``None`` when there is nothing to fuse.
    """
    if chains is None:
        chains = find_band_chains(g)
    if not chains:
        return None
    chain_of: Dict[int, Tuple[str, int]] = {}
    internal: set = set()
    for ch in chains:
        cat = ch[-1]
        for j, op in enumerate(ch):
            chain_of[id(op)] = (cat.name, j)
            if op is not cat:
                internal.update(t.storage() for t in op.outputs)

    ng = Graph(g.name + "_fused")
    ng.batch = g.batch
    mapping: Dict[Tensor, Tensor] = {}

    def map_t(t: Tensor) -> Tensor:
        if t in mapping:
            return mapping[t]
        if t.alias_of is not None:
            base = map_t(t.alias_of)
            nt = ng.tensor(t.name, t.shape, t.dtype_bytes, t.kind,
                           alias_of=base)
        else:
            kind = "scratch" if t in internal else t.kind
            nt = ng.tensor(t.name, t.shape, t.dtype_bytes, kind)
        mapping[t] = nt
        return nt

    for op in g.ops:
        params = dict(op.params)
        if id(op) in chain_of:
            cname, stage = chain_of[id(op)]
            params.update(fuse_chain=cname, fuse_stage=stage)
        ng.add(Op(op.kind, [map_t(t) for t in op.inputs],
                  [map_t(t) for t in op.outputs], params, op.name))
    ng.validate()
    return ng


def chain_members(g: Graph) -> Dict[str, List[Op]]:
    """Fused chains of a graph, keyed by chain name, members in graph order
    (``fuse_stage`` ascending — asserted, since the Pallas layer relies on
    graph order matching stage order)."""
    out: Dict[str, List[Op]] = {}
    for op in g.ops:
        c = op.params.get("fuse_chain")
        if c is not None:
            out.setdefault(c, []).append(op)
    for name, ops in out.items():
        stages = [op.params["fuse_stage"] for op in ops]
        assert stages == list(range(len(ops))), \
            f"chain {name!r}: graph order disagrees with stage order"
    return out


def order_pinned(g: Graph) -> bool:
    """Does this graph refuse re-serialisation and order-search moves?

    Fused band chains pin execution order: each chain lowers to ONE Pallas
    kernel whose members must stay contiguous with ``fuse_stage`` ascending
    (see :func:`chain_members`), so both :class:`pipeline.SerialisePass` and
    the joint execution-order search leave fused variants in construction
    order. Plain *split* variants are NOT pinned — band ops are ordinary
    graph ops with explicit pads, so split variants re-enter the joint
    search like any other graph."""
    return any("fuse_chain" in op.params for op in g.ops)


def auto_split(g: Graph, max_parts: int = 8, rounds: int = 3,
               overlap: bool = True, method: str = "algorithmic",
               profile: str = "paper") -> Tuple[Graph, int, List[str]]:
    """Greedy: while the planned peak improves, split the pair whose live
    set defines the peak. Returns (graph, total recompute elems, log).

    ``overlap=True`` (the default) evaluates every candidate with the
    overlap-aware DMO planner, so the chosen splits are the ones that
    compose best with the diagonal relaxation — the banded O_s lets each
    halo tuck into its band output's tail. ``overlap=False`` keeps the
    paper's conservative route (splitting and overlap priced separately).
    """
    plan = ((lambda gr: plan_dmo(gr, method=method, profile=profile))
            if overlap else plan_original)
    log: List[str] = []
    total_rc = 0
    cur = g
    for _ in range(rounds):
        base = plan(cur).peak_bytes
        scopes = cur.scopes()
        # find the op step with the largest live-byte sum
        peak_step, peak_live = 0, 0
        for i in range(len(cur.ops)):
            live = sum(t.nbytes for t, (s, e) in scopes.items() if s <= i <= e)
            if live > peak_live:
                peak_step, peak_live = i, live
        best = None
        # ia >= 0: when op 0 defines the peak, probing ia = -1 would
        # Python-wrap split_pair to the bogus (last, first) pair
        for ia in (i for i in (peak_step - 1, peak_step) if i >= 0):
            # dict.fromkeys: dedupe the candidate list when max_parts is 2
            # or 4 (each duplicate re-plans the whole graph)
            for parts in dict.fromkeys((2, 4, max_parts)):
                if parts < 2:
                    continue
                r = split_pair(cur, ia, parts)
                if r is None:
                    continue
                ng, rc = r
                peak = plan(ng).peak_bytes
                if peak < base and (best is None or peak < best[0]):
                    best = (peak, ng, rc, ia, parts)
        if best is None:
            break
        peak, cur, rc, ia, parts = best
        total_rc += rc
        log.append(f"split ops {ia},{ia + 1} into {parts}: "
                   f"{base / 1024:.0f} -> {peak / 1024:.0f} KB "
                   f"(+{rc} recomputed elems)")
    return cur, total_rc, log
