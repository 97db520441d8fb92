"""Meshes: named axes over devices.

The counterpart of the reference's ``src/repro/launch/mesh.py``.
Single pod: (data=16, model=16) = 256 chips. Multi-pod: (pod=2, data=16,
model=16) = 512 chips; the ``pod`` axis composes with ``data`` for batch
sharding (pure data parallel across pods).

The port has no SPMD compiler, so a :class:`Mesh` is a description: axis
names and sizes, the shape the sharding rules (``launch/specs.py``) and
the dry run (``launch/dryrun.py``) read, and, for the host mesh, the
devices it covers. Building one touches no device.

A :class:`RuntimeMesh` runs one: a (data, model) mesh of ``data * model``
processes of ``torch.distributed``, rank ``data_index * model +
model_index`` (row-major, as ``jax.make_mesh`` orders its devices), with
one process group an axis (:func:`open_mesh`). Each rank holds its own
shard of every tensor explicitly; the collectives that join them are in
``repro_torch/sharding.py``, over :meth:`RuntimeMesh.gather`. :func:`spawn`
runs a function on every rank of one. The backend is the caller's:
``"nccl"`` takes one card a rank and refuses ranks that would share one;
``"gloo"`` runs ranks on one host, on the CPU or sharing the one card.
Under gloo an all-gather moves its bytes through buffers the ranks of a
group map from each other (:class:`_Exchange`: files beside the
``file://`` store on the CPU, CUDA IPC on the card), gloo's barriers
ordering the writes and the reads: gloo's own all-gather passes through
the host's sockets, about 0.3 GB/s for 64 MB between two CPU ranks, where
a layer's expert shards under fsdp are 67 MB a rank at olmoe-1b-7b's
width. Nothing switches backend or device on its own.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import tempfile
import time
import traceback
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes; ``devices`` the devices of a host mesh
    (empty for a description of a production mesh)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[str, ...] = ()

    @property
    def shape(self) -> "OrderedDict[str, int]":
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh over the cards that are visible (the CPU when
    there is none), shrunk to (1, 1) when they are too few."""
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devices = tuple(f"cuda:{i}" for i in range(n)) or ("cpu",)
    if data * model > len(devices):
        data, model = 1, 1
    return Mesh(("data", "model"), (data, model), devices[:data * model])


# ---------------------------------------------------------------------------
# A mesh of processes
# ---------------------------------------------------------------------------


class _Exchange:
    """All-gathers among the ranks of one group on one host: each rank
    copies its bytes into a buffer of its own that every rank of the group
    maps, then copies out the others'. A gloo barrier after the writes and
    one after the reads order them. Copies only: the bytes arrive exact."""

    def __init__(self, group, ranks: List[int], rank: int, device,
                 where: str):
        self.group, self.n, self.i = group, len(ranks), ranks.index(rank)
        self.device, self.rank = device, rank
        #: the CPU's buffers are files ``where``-<rank>-<bytes>
        self.where = where
        self.bufs: List[Any] = []
        self.nbytes = 0

    def _grow(self, nbytes: int) -> None:
        """Buffers of at least ``nbytes`` on every rank of the group, each
        rank's mapped by the others (every rank grows at the same call:
        they gather the same shapes in the same order). Made outside
        inference mode: a buffer made in it could not be written out of
        it."""
        import torch
        size = 1 << max(20, (nbytes - 1).bit_length())
        self.bufs = []
        with torch.inference_mode(False):
            self._map(size)

    def _map(self, size: int) -> None:
        import torch
        import torch.distributed as dist
        if self.device.type == "cuda":
            from torch.multiprocessing.reductions import reduce_tensor
            mine = torch.empty(size, dtype=torch.uint8, device=self.device)
            handle = reduce_tensor(mine)
        else:
            path = f"{self.where}-{self.rank}-{size}"
            mine = torch.from_file(path, shared=True, size=size,
                                   dtype=torch.uint8)
            handle = path
        handles: List[Any] = [None] * self.n
        dist.all_gather_object(handles, handle, group=self.group)
        for j, h in enumerate(handles):
            if j == self.i:
                self.bufs.append(mine)
            elif self.device.type == "cuda":
                self.bufs.append(h[0](*h[1]))
            else:
                self.bufs.append(torch.from_file(h, shared=True, size=size,
                                                 dtype=torch.uint8))
        self.nbytes = size

    def _settle(self) -> None:
        import torch.distributed as dist
        if self.device.type == "cuda":
            import torch
            torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)

    def gather(self, x):
        """Every rank's ``x`` in ascending index (this rank's: ``x``)."""
        nbytes = x.numel() * x.element_size()
        if nbytes > self.nbytes:
            self._grow(nbytes)
        self.bufs[self.i][:nbytes].copy_(
            x.reshape(-1).view(self.bufs[0].dtype))
        self._settle()
        out = [x if j == self.i else
               b[:nbytes].view(x.dtype).view(x.shape).clone()
               for j, b in enumerate(self.bufs)]
        self._settle()
        return out


class RuntimeMesh:
    """This rank's place in a (data, model) mesh of processes: its rank,
    its coordinates, its device and one process group an axis (the ranks
    that differ from it along that axis only, in ascending index), with
    its all-gathers under gloo (``exchanges``)."""

    axis_names = ("data", "model")

    def __init__(self, data: int, model: int, rank: int, backend: str,
                 device, groups: Dict[str, Any],
                 exchanges: Optional[Dict[str, _Exchange]] = None):
        self.axis_sizes = (data, model)
        self.rank = rank
        self.backend = backend
        self.device = device
        self.groups = groups
        self.exchanges = exchanges or {}

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return self.axis_sizes[0] * self.axis_sizes[1]

    @property
    def coords(self) -> Tuple[int, int]:
        """(data_index, model_index)."""
        return divmod(self.rank, self.axis_sizes[1])

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def gather(self, x, axis: str) -> list:
        """Every rank's ``x`` along ``axis``, in ascending index: copies of
        the group's bytes (gloo: :class:`_Exchange`; nccl: its
        all-gather)."""
        if self.backend == "gloo":
            return self.exchanges[axis].gather(x.contiguous())
        import torch
        import torch.distributed as dist
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(out, x, group=self.groups[axis])
        return out

    def close(self) -> None:
        """Unmap the peers' buffers once every rank is done with them, then
        leave the process group."""
        import torch.distributed as dist
        for ex in self.exchanges.values():
            ex.bufs = []
        dist.barrier()
        dist.destroy_process_group()


def axis_ranks(data: int, model: int) -> Dict[str, List[List[int]]]:
    """Every group of each axis, as lists of ranks in ascending index: the
    data axis's groups are the mesh's columns, the model axis's its rows."""
    return {"data": [[d * model + m for d in range(data)]
                     for m in range(model)],
            "model": [[d * model + m for m in range(model)]
                      for d in range(data)]}


def rank_device(backend: str, rank: int, world: int, device=None):
    """The device of ``rank`` under ``backend``. ``"nccl"`` takes card
    ``rank`` and raises where the cards are fewer than the ranks (two
    ranks would share one); ``"gloo"`` takes ``device`` (None: the card,
    shared by every rank; ``"cpu"``)."""
    import torch
    from repro_torch.kernels.runtime import resolve_device
    if backend == "nccl":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > n:
            raise ValueError(f"nccl takes one card a rank: {world} ranks on "
                             f"{n} card(s) would share one; use 'gloo'")
        dev = torch.device("cuda", rank)
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"nccl rank {rank} runs on {dev}, not {device}")
        return dev
    if backend == "gloo":
        return resolve_device(device)
    raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")


def open_mesh(data: int, model: int, *, backend: str, rank: int,
              init_method: str, device=None,
              timeout: float = 600.0) -> RuntimeMesh:
    """Join the ``data * model`` process group as ``rank`` and make one
    subgroup a group of each axis (every rank makes them all, in the same
    order, as ``torch.distributed.new_group`` asks)."""
    import torch
    import torch.distributed as dist
    world = data * model
    dev = rank_device(backend, rank, world, device)
    if backend == "gloo" and not init_method.startswith("file://"):
        raise ValueError("gloo ranks map their buffers beside a file:// "
                         f"store, not {init_method!r}")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    groups, exchanges = {}, {}
    for axis, lists in axis_ranks(data, model).items():
        for ranks in lists:
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
                if backend == "gloo":
                    where = os.path.join(os.path.dirname(
                        init_method[len("file://"):]), f"{axis}{ranks[0]}")
                    exchanges[axis] = _Exchange(g, ranks, rank, dev, where)
    return RuntimeMesh(data, model, rank, backend, dev, groups, exchanges)


def _rank_main(fn, rank, data, model, backend, device, init_method, timeout,
               args, results) -> None:
    try:
        mesh = open_mesh(data, model, backend=backend, rank=rank,
                         init_method=init_method, device=device,
                         timeout=timeout)
        try:
            out = fn(mesh, *args)
        finally:
            mesh.close()
        results.put((rank, True, out))
    except Exception:       # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, data: int, model: int, *, backend: str,
          device=None, args: Sequence = (), timeout: float = 600.0
          ) -> List[Any]:
    """``fn(mesh, *args)`` on every rank of a (data, model) mesh, each a
    process of its own (``spawn`` start method: ``fn`` and ``args`` are
    pickled, ``fn`` by its import path), joined through a ``file://``
    store in a temporary directory, so no port is needed. Returns each
    rank's result in rank order. A rank that raises, dies, or has not
    answered ``timeout`` seconds after the start fails the whole run:
    every rank is killed and the error raised here."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    n = data * model
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, data, model, backend, device, init,
                                   timeout, tuple(args), results),
                             daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        out: Dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"mesh ({data}, {model}): ranks "
                        f"{sorted(set(range(n)) - set(out))} gave no result "
                        f"within {timeout:.0f} s")
                try:
                    r, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        time.sleep(1.0)     # a result may still be in flight
                        if results.empty():
                            raise RuntimeError(
                                f"mesh ({data}, {model}): rank(s) {dead} "
                                f"exited ({[procs[r].exitcode for r in dead]})"
                                " without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"mesh ({data}, {model}) rank {r} "
                                       f"raised:\n{payload}")
                out[r] = payload
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
    return [out[r] for r in range(n)]
