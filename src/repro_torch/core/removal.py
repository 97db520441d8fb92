"""Operation removal (paper §II.C): concat/pack elision.

Element re-arrangement ops like concat define the peak memory of models such
as SqueezeNet — two copies of the same elements (the branch outputs and the
aggregated tensor) are live at once. If upstream ops can write *directly
into* the aggregated tensor, the copies disappear. TFLite Micro cannot (its
offset function is contiguous-only); the paper notes it "could be added with
a small change to the memory offset function". Here the graph IR supports
it natively: a concat input becomes a *view* into the concat output
(``Tensor.alias_of`` + ``alias_offset``), its producer writes straight into
the aggregated allocation, and the concat op disappears.

The paper also notes this changes the producers' ``O_s`` computation (their
write stride changes); we take the conservative route the paper implies:
producers that write into an aggregated view get ``O_s = 0`` (the overlap
relaxation is dropped for them — see ``_compute_overlaps``' alias check).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.graph import Graph, Op, Tensor


def removable(g: Graph, op: Op) -> bool:
    """A concat is removable when each input is produced by exactly one op,
    consumed only by this concat, and is not itself a view."""
    if op.kind != "concat":
        return False
    for t in op.inputs:
        s = t.storage()
        if s.kind in ("input", "weight") or t.alias_of is not None:
            return False
        consumers = [o for o in g.ops
                     if s in [x.storage() for x in o.inputs]]
        if consumers != [op]:
            return False
    return True


def remove_concats(g: Graph) -> Graph:
    """Return a new graph with every removable concat elided."""
    ng = Graph(g.name + "_noconcat")
    ng.batch = g.batch
    mapping: Dict[Tensor, Tensor] = {}

    def map_t(t: Tensor) -> Tensor:
        s = t.storage()
        if s not in mapping:
            mapping[s] = ng.tensor(s.name, s.shape, s.dtype_bytes, s.kind)
        return mapping[s]

    to_remove = [op for op in g.ops if removable(g, op)]
    view_of: Dict[Tensor, tuple] = {}   # branch storage -> (concat out, off)
    for op in to_remove:
        out = map_t(op.output)
        axis = op.params.get("axis", -1)
        ndim = len(op.output.shape)
        if axis < 0:
            axis += ndim
        # element offset of each branch within the aggregated tensor: exact
        # for the outermost axis; inner-axis concats are strided views (the
        # "offset function change") — the view still owns no storage.
        off = 0
        inner = 1
        for d in range(axis + 1, ndim):
            inner *= op.output.shape[d]
        for t in op.inputs:
            s = t.storage()
            view_of[s] = (out, off * inner if axis == 0 else 0)
            off += t.shape[axis]

    for op in g.ops:
        if op in to_remove:
            continue
        ins: List[Tensor] = []
        for t in op.inputs:
            s = t.storage()
            if s in view_of:
                parent, off = view_of[s]
                v = ng.tensor(f"{s.name}_view", s.shape, s.dtype_bytes,
                              "intermediate", alias_of=parent)
                ins.append(v)
            else:
                ins.append(map_t(t))
        outs: List[Tensor] = []
        for t in op.outputs:
            s = t.storage()
            if s in view_of:
                parent, off = view_of[s]
                v = ng.tensor(f"{s.name}_view", s.shape, s.dtype_bytes,
                              "intermediate", alias_of=parent)
                outs.append(v)
            else:
                outs.append(map_t(t))
        ng.add(Op(op.kind, ins, outs, dict(op.params), op.name))
    ng.validate()
    return ng
