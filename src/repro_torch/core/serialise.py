"""Graph serialisation (paper §II.B).

Connected graphs (Inception, DenseNet, NasNet, ...) admit many valid
execution orders; the order changes which tensors are live simultaneously and
therefore the peak arena size. Finding the optimal order is NP-hard; the
paper evaluates an *eager* and a *lazy* heuristic order per model and keeps
the better plan. Both are implemented here, plus a memory-greedy order
(beyond-paper: pick the ready op that minimises live bytes after execution)
and :class:`OrderMoves`, the move-legality oracle the joint
execution-order x overlap search (``planner.plan_joint``) walks the space of
dependency-respecting linearisations with.
"""
from __future__ import annotations

import heapq
import random
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.graph import Graph, Op, Tensor


def _deps(graph: Graph) -> Dict[Op, Set[Op]]:
    """Producer dependencies, *view-aware*.

    After §II.C concat removal an op's output may be a view into an
    aggregated tensor: several ops then write disjoint regions of ONE
    storage. A storage-keyed producer map keeps only the last such writer,
    under-constraining every reader of the aggregate — which is why removal
    graphs used to be pinned to construction order. Here a reader of an
    exactly-produced tensor (or view) depends on its producer, and a reader
    that resolves through storage depends on *every* writer into that
    storage (branch writers stay mutually unordered — they touch disjoint
    regions — so removal variants admit real re-serialisation)."""
    producer: Dict[int, Op] = {}          # id(exact output tensor) -> op
    writers: Dict[Tensor, List[Op]] = {}  # storage -> every op writing into it
    for op in graph.ops:
        for t in op.outputs:
            producer[id(t)] = op
            writers.setdefault(t.storage(), []).append(op)
    deps: Dict[Op, Set[Op]] = {}
    for op in graph.ops:
        d: Set[Op] = set()
        for t in op.inputs:
            if id(t) in producer:
                d.add(producer[id(t)])
            if t.storage() in writers:
                d.update(writers[t.storage()])
        d.discard(op)
        deps[op] = d
    return deps


def _consumers(deps: Dict[Op, Set[Op]]) -> Dict[Op, List[Op]]:
    """Invert a dependency map: op -> ops that depend on it."""
    out: Dict[Op, List[Op]] = {op: [] for op in deps}
    for op, d in deps.items():
        for dep in d:
            out[dep].append(op)
    return out


def eager_order(graph: Graph) -> List[Op]:
    """FIFO topological order: run each op as soon as its inputs exist
    (breadth-first, construction order as tie-break).

    Kahn's algorithm with a construction-index min-heap: the historical
    pending-list rescan picked the *first* ready op in construction order,
    which is exactly the minimum construction index among ready ops — so the
    ready-heap produces the bit-identical order in O(E log V) instead of
    O(V^2 * E)."""
    deps = _deps(graph)
    consumers = _consumers(deps)
    idx = {op: i for i, op in enumerate(graph.ops)}
    indeg = {op: len(deps[op]) for op in graph.ops}
    ready = [idx[op] for op in graph.ops if indeg[op] == 0]
    heapq.heapify(ready)
    order: List[Op] = []
    while ready:
        op = graph.ops[heapq.heappop(ready)]
        order.append(op)
        for c in consumers[op]:
            indeg[c] -= 1
            if indeg[c] == 0:
                heapq.heappush(ready, idx[c])
    if len(order) != len(graph.ops):  # pragma: no cover - cyclic graph
        raise ValueError("graph has a cycle")
    return order


def lazy_order(graph: Graph) -> List[Op]:
    """Depth-first from the model outputs: each value is computed as late as
    its deepest consumer chain requires (post-order DFS)."""
    deps = _deps(graph)
    idx = {op: i for i, op in enumerate(graph.ops)}
    consumers: Dict[Op, int] = {op: 0 for op in graph.ops}
    for op in graph.ops:
        for d in deps[op]:
            consumers[d] += 1
    roots = [op for op in graph.ops if consumers[op] == 0]
    order: List[Op] = []
    seen: Set[Op] = set()

    def visit(op: Op) -> None:
        if op in seen:
            return
        seen.add(op)
        for d in sorted(deps[op], key=idx.__getitem__):
            visit(d)
        order.append(op)

    for r in roots:
        visit(r)
    return order


def memory_greedy_order(graph: Graph) -> List[Op]:
    """Beyond-paper heuristic: among ready ops, run the one minimising the
    total bytes live after it executes (ties: construction order).

    The ready set is maintained Kahn-style (indegree counting) instead of
    rescanning the whole pending list each step; the construction-index
    tie-break is order-identical to the historical ``pending.index``
    tie-break, since removal preserves the relative construction order of
    the remaining ops."""
    deps = _deps(graph)
    consumers = _consumers(deps)
    idx = {op: i for i, op in enumerate(graph.ops)}
    indeg = {op: len(deps[op]) for op in graph.ops}
    ready: Set[Op] = {op for op in graph.ops if indeg[op] == 0}
    remaining_uses: Dict[Tensor, int] = {}
    for op in graph.ops:
        for t in op.inputs:
            s = t.storage()
            if s.kind != "weight":
                remaining_uses[s] = remaining_uses.get(s, 0) + 1
    live: Set[Tensor] = {
        t.storage() for t in graph.tensors if t.kind == "input"
    }
    order: List[Op] = []
    while ready:

        def after_bytes(op: Op) -> int:
            uses = dict(remaining_uses)
            nxt = set(live)
            for t in op.outputs:
                s = t.storage()
                if s.kind != "weight":
                    nxt.add(s)
            for t in op.inputs:
                s = t.storage()
                if s in uses:
                    uses[s] -= 1
                    if uses[s] == 0 and s.kind not in ("input", "output"):
                        nxt.discard(s)
            return sum(t.nbytes for t in nxt)

        best = min(ready, key=lambda op: (after_bytes(op), idx[op]))
        order.append(best)
        ready.discard(best)
        for c in consumers[best]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.add(c)
        for t in best.outputs:
            s = t.storage()
            if s.kind != "weight":
                live.add(s)
        for t in best.inputs:
            s = t.storage()
            if s in remaining_uses:
                remaining_uses[s] -= 1
                if remaining_uses[s] == 0 and s.kind not in ("input", "output"):
                    live.discard(s)
    if len(order) != len(graph.ops):  # pragma: no cover - cyclic graph
        raise ValueError("graph has a cycle")
    return order


def candidate_orders(graph: Graph) -> List[List[Op]]:
    """The paper's eager & lazy orders (+ the memory-greedy extension)."""
    orders = [eager_order(graph), lazy_order(graph)]
    try:
        orders.append(memory_greedy_order(graph))
    except Exception:  # pragma: no cover - defensive
        pass
    # dedupe
    uniq: List[List[Op]] = []
    for o in orders:
        if o not in uniq:
            uniq.append(o)
    return uniq


class OrderMoves:
    """Move-legality oracle over dependency-respecting linearisations.

    The joint execution-order x overlap search (``planner.plan_joint``)
    perturbs a topological order with adjacent transpositions and block
    moves; whether a move is legal is decided here, against the same
    view-aware :func:`_deps` precedence relation every serialisation
    heuristic uses — aggregated-view writers stay ordered before their
    readers, so a legal move can never produce an order that clobbers a
    §II.C removal region."""

    def __init__(self, graph: Graph):
        self.graph = graph
        self.deps = _deps(graph)
        self.idx = {op: i for i, op in enumerate(graph.ops)}

    def signature(self, order: Sequence[Op]) -> Tuple[int, ...]:
        """Hashable identity of an order (construction indices) — the
        memoisation key that makes repeated search neighbourhoods free."""
        return tuple(self.idx[op] for op in order)

    def is_topological(self, order: Sequence[Op]) -> bool:
        if sorted(self.signature(order)) != list(range(len(self.graph.ops))):
            return False
        pos = {op: i for i, op in enumerate(order)}
        return all(pos[d] < pos[op]
                   for op in order for d in self.deps[op])

    # -- adjacent transposition ---------------------------------------------
    def legal_swap(self, order: Sequence[Op], i: int) -> bool:
        """May ``order[i]`` and ``order[i+1]`` exchange places?"""
        return order[i] not in self.deps[order[i + 1]]

    def legal_swaps(self, order: Sequence[Op]) -> List[int]:
        return [i for i in range(len(order) - 1)
                if self.legal_swap(order, i)]

    def swap(self, order: Sequence[Op], i: int) -> List[Op]:
        new = list(order)
        new[i], new[i + 1] = new[i + 1], new[i]
        return new

    # -- block move ----------------------------------------------------------
    def legal_block_move(self, order: Sequence[Op], i: int, j: int) -> bool:
        """May ``order[i]`` be re-inserted at position ``j``? Moving later
        requires nothing it hops over to depend on it; moving earlier
        requires it to depend on nothing it hops over."""
        op = order[i]
        if j > i:
            return all(op not in self.deps[order[k]]
                       for k in range(i + 1, j + 1))
        return all(order[k] not in self.deps[op] for k in range(j, i))

    def block_move(self, order: Sequence[Op], i: int, j: int) -> List[Op]:
        new = list(order)
        new.insert(j, new.pop(i))
        return new

    # -- sampling ------------------------------------------------------------
    def random_topological(self, rng: random.Random,
                           order: Optional[Sequence[Op]] = None) -> List[Op]:
        """A uniformly-perturbed dependency-respecting linearisation: Kahn
        with the ready op drawn at random. Used by the search restarts and
        by the any-linearisation safety property tests."""
        ops = list(order if order is not None else self.graph.ops)
        consumers = _consumers(self.deps)
        indeg = {op: len(self.deps[op]) for op in ops}
        ready = [op for op in ops if indeg[op] == 0]
        out: List[Op] = []
        while ready:
            op = ready.pop(rng.randrange(len(ready)))
            out.append(op)
            for c in consumers[op]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(out) != len(ops):  # pragma: no cover - cyclic graph
            raise ValueError("graph has a cycle")
        return out
