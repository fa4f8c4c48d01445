"""comms_t-shaped facade over a mesh of torch devices (counterpart of
``raft_tpu.comms.comms``).

raft_tpu runs single-controller SPMD: ``shard_map`` over a
``jax.sharding.Mesh``, with collectives named by a mesh axis.  The port
keeps the verb surface and moves the SPMD body into plain Python:

- :class:`Mesh` is a grid of ``torch.device`` entries with named axes.
  :func:`make_mesh` takes every visible CUDA device by default; a caller
  may list one device several times (``devices=["cuda:0"] * 4``: four
  shards on one card, the counterpart of raft_tpu's virtual host devices,
  and ``["cpu"] * 8`` in the CPU tests).
- :class:`Comms` binds the mesh to one axis.  Every verb takes a
  rank-ordered list of per-shard tensors (one entry for each of this
  process's mesh positions, in mesh order) and returns one in the same
  order, each entry on its shard's device.  Sums are taken in rank order
  and gathers concatenate in rank order, so a result does not depend on
  where the shards live, and ties broken by position stay raft_tpu's.
- :meth:`Comms.run` calls ``fn(rank, *shard_args, *replicated)`` on each
  shard in turn (the explicit ``rank`` replaces ``lax.axis_index``).
  Shards that share one card run one after another: that is the card's
  multi-shard semantics, not a speed-up.

Verb mapping (ref: core/comms.hpp:125-232): allreduce / bcast / reduce /
allgather / gather / allgatherv / reducescatter / device_sendrecv (ring
neighbour exchange) / alltoall, ``comm_split`` (a ``Comms`` bound to
another axis), ``barrier_value`` and ``sync_stream``.

A mesh made by :func:`raft_tpu_torch.comms.bootstrap.global_mesh` spans
several processes, process axis outermost; each process holds its own
positions.  A reduction first combines a process's own shards in rank
order, then reduces those partials across processes with the
``torch.distributed`` group's ``all_reduce`` (NCCL's reduction on GPUs):
only the payload travels.  So two processes of two shards each sum
``(x0 + x1) + (x2 + x3)`` where one process of four sums
``((x0 + x1) + x2) + x3``: equal for integers, maxima and minima, within
rounding for float sums.  The moving verbs (bcast, the gathers,
sendrecv, alltoall) all-gather every process's stack of shards and pick
in rank order as one process would, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


class Mesh:
    """A grid of devices with named axes (the counterpart of
    ``jax.sharding.Mesh``).

    ``devices`` lists this process's shards in mesh order (row-major over
    ``axis_names``); ``shape`` is the whole mesh's.  A mesh spanning
    ``process_count`` processes (``bootstrap.global_mesh``) holds the
    positions ``[process_index * L, (process_index + 1) * L)`` of the
    flattened grid here, ``L = len(devices)``, and ``group`` is the
    ``torch.distributed`` group its verbs gather through."""

    def __init__(self, devices: Sequence[DeviceLike], axis_names: Tuple[str, ...] = ("data",),
                 shape: Optional[Tuple[int, ...]] = None, *, process_count: int = 1,
                 process_index: int = 0, group=None, backend: Optional[str] = None):
        self.local_devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        total = len(self.local_devices) * int(process_count)
        if shape is None:
            shape = (total,) + (1,) * (len(self.axis_names) - 1)
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes {self.axis_names}")
        if int(np.prod(shape)) != total:
            raise ValueError(f"mesh shape {shape} holds {int(np.prod(shape))} positions, "
                             f"not the {total} given ({len(self.local_devices)} devices x "
                             f"{process_count} processes)")
        self.grid_shape = shape
        self.process_count = int(process_count)
        self.process_index = int(process_index)
        self.group = group
        self.backend = backend

    @property
    def shape(self) -> dict:
        """axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.grid_shape))

    @property
    def size(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def local_positions(self) -> range:
        n = len(self.local_devices)
        return range(self.process_index * n, (self.process_index + 1) * n)

    def coords(self, position: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(position, self.grid_shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.local_devices]}, "
                f"process {self.process_index} of {self.process_count})")


def _cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh takes the visible CUDA devices by default and none is "
            "available; pass devices=['cpu'] * n to run the mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    visible CUDA device; a device may repeat: several shards on one card)."""
    devs = list(devices) if devices is not None else _cuda_devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"n_devices={n_devices} but only {len(devs)} devices were given")
    return Mesh(devs[:n_devices], axis_names, shape)


_OPS = ("sum", "max", "min", "prod")


def _combine(op: str, acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (acc + x if op == "sum" else acc * x if op == "prod"
            else torch.maximum(acc, x) if op == "max" else torch.minimum(acc, x))


def _identity(op: str, dtype: torch.dtype):
    """The element a process with no member of a group contributes."""
    if op in ("sum", "prod"):
        return 0 if op == "sum" else 1
    if dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    return torch.iinfo(dtype).min if op == "max" else torch.iinfo(dtype).max


#: the ``torch.distributed.ReduceOp`` of each op
_DIST_OPS = {"sum": "SUM", "prod": "PRODUCT", "max": "MAX", "min": "MIN"}


@dataclass
class Comms:
    """Collective verbs bound to a mesh axis (ref: comms_t facade,
    core/comms.hpp:125)."""

    mesh: Mesh
    axis: str = "data"
    _groups: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        if self.axis not in self.mesh.axis_names:
            raise ValueError(f"axis {self.axis!r} not in mesh {self.mesh.axis_names}")

    # -- topology ----------------------------------------------------------
    def get_size(self) -> int:
        return self.mesh.shape[self.axis]

    def ranks(self) -> List[int]:
        """The rank along this axis of each of this process's shards."""
        a = self.mesh.axis_names.index(self.axis)
        return [self.mesh.coords(p)[a] for p in self.mesh.local_positions]

    @property
    def devices(self) -> List[torch.device]:
        """This process's shard devices, in mesh order."""
        return list(self.mesh.local_devices)

    def comm_split(self, axis: str) -> "Comms":
        """Sub-communicator = another mesh axis (ref: comms_t::comm_split)."""
        if axis not in self.mesh.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh {self.mesh.axis_names}")
        return Comms(self.mesh, axis)

    def _group(self, position: int) -> List[int]:
        """Mesh positions of ``position``'s group along the axis, rank order."""
        g = self._groups.get(position)
        if g is None:
            a = self.mesh.axis_names.index(self.axis)
            c = list(self.mesh.coords(position))
            g = []
            for r in range(self.get_size()):
                c[a] = r
                g.append(int(np.ravel_multi_index(c, self.mesh.grid_shape)))
            self._groups[position] = g
        return g

    # -- the SPMD body -----------------------------------------------------
    def shard(self, x: torch.Tensor, dim: int = 0) -> List[torch.Tensor]:
        """Cut ``x`` into this axis's size pieces along ``dim`` (equal
        pieces: the size must divide it) and give each shard its rank's
        piece on its device (the counterpart of ``P(axis, ...)``)."""
        n = self.get_size()
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide the "
                             f"{n}-way axis {self.axis!r}")
        pieces = torch.chunk(x, n, dim=dim)
        return [pieces[r].to(d) for r, d in zip(self.ranks(), self.devices)]

    def replicate(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x`` on every shard's device (one copy a device)."""
        copies = {}
        return [copies.setdefault(d, x.to(d)) for d in self.devices]

    def run(self, fn: Callable, *sharded: Sequence, replicated: Sequence = ()) -> list:
        """``fn(rank, *shard_args, *replicated)`` on each of this process's
        shards, in mesh order: the ``shard_map`` body.  ``sharded`` are
        rank-ordered lists (one entry a shard); ``replicated`` tensors are
        moved to each shard's device.  Returns the list of results."""
        for s in sharded:
            if len(s) != len(self.devices):
                raise ValueError(f"a sharded argument has {len(s)} entries for "
                                 f"{len(self.devices)} shards")
        reps = [self.replicate(r) if isinstance(r, torch.Tensor) else [r] * len(self.devices)
                for r in replicated]
        return [fn(rank, *(s[j] for s in sharded), *(r[j] for r in reps))
                for j, rank in enumerate(self.ranks())]

    # -- collectives -------------------------------------------------------
    def _full(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every mesh position's tensor, in mesh order: this process's
        own, then (across processes) all-gathered through the group."""
        xs = list(xs)
        if len(xs) != len(self.devices):
            raise ValueError(f"{len(xs)} tensors for {len(self.devices)} shards")
        if self.mesh.process_count == 1:
            return xs
        import torch.distributed as dist

        wire = (torch.device("cpu") if self.mesh.backend == "gloo"
                else self.mesh.local_devices[0])
        local = torch.stack([x.to(wire) for x in xs])
        bufs = [torch.empty_like(local) for _ in range(self.mesh.process_count)]
        dist.all_gather(bufs, local, group=self.mesh.group)
        return [b[i] for b in bufs for i in range(len(xs))]

    def _each(self, xs, combine):
        """``combine(members, position, device)`` for each local position,
        ``members`` its group's tensors in rank order."""
        full = self._full(xs)
        return [combine([full[m] for m in self._group(p)], p, d)
                for p, d in zip(self.mesh.local_positions, self.devices)]

    def allreduce(self, xs: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
        """The reduction over the axis on every shard: this process's
        members of a group combined in rank order, then (for a group that
        spans processes) the partials reduced by the process group's
        ``all_reduce``."""
        if op not in _OPS:
            raise ValueError(f"unsupported reduce op {op!r}")
        xs = list(xs)
        if len(xs) != len(self.devices):
            raise ValueError(f"{len(xs)} tensors for {len(self.devices)} shards")
        partial = {}
        # local positions ascend, and so does a group's rank order
        for p, x in zip(self.mesh.local_positions, xs):
            key = tuple(self._group(p))
            partial[key] = x if key not in partial else _combine(
                op, partial[key], x.to(partial[key].device))
        if self.mesh.process_count > 1:
            self._reduce_across(partial, op, xs[0])
        return [partial[tuple(self._group(p))].to(d)
                for p, d in zip(self.mesh.local_positions, self.devices)]

    def _reduce_across(self, partial: dict, op: str, like: torch.Tensor) -> None:
        """Reduce ``partial`` (group → this process's combined members)
        across processes, in place: one ``all_reduce`` over the stack of
        every group that spans processes (the same list on every process;
        a process with no member of a group sends the op's identity)."""
        import torch.distributed as dist

        n_local = len(self.mesh.local_devices)
        spanning = sorted({g for g in (tuple(self._group(p)) for p in range(self.mesh.size))
                           if len({m // n_local for m in g}) > 1})
        if not spanning:
            return
        wire = (torch.device("cpu") if self.mesh.backend == "gloo"
                else self.mesh.local_devices[0])
        fill = _identity(op, like.dtype)
        stack = torch.stack([partial[g].to(wire) if g in partial
                             else torch.full_like(like, fill, device=wire) for g in spanning])
        dist.all_reduce(stack, op=getattr(dist.ReduceOp, _DIST_OPS[op]),
                        group=self.mesh.group)
        for g, v in zip(spanning, stack):
            if g in partial:
                partial[g] = v.to(partial[g].device)

    def bcast(self, xs: Sequence[torch.Tensor], root: int = 0) -> List[torch.Tensor]:
        return self._each(xs, lambda members, p, d: members[root].to(d))

    def reduce(self, xs: Sequence[torch.Tensor], root: int = 0,
               op: str = "sum") -> List[torch.Tensor]:
        """As raft_tpu: the reduction on every shard (meaningful at root)."""
        return self.allreduce(xs, op)

    def allgather(self, xs: Sequence[torch.Tensor], *, axis: int = 0,
                  tiled: bool = True) -> List[torch.Tensor]:
        """Rank-ordered concatenation (``tiled``) or stack along ``axis``."""
        join = torch.cat if tiled else torch.stack
        return self._each(xs, lambda members, p, d: join([m.to(d) for m in members], dim=axis))

    def gather(self, xs: Sequence[torch.Tensor], root: int = 0, *,
               axis: int = 0) -> List[torch.Tensor]:
        return self.allgather(xs, axis=axis)

    def allgatherv(self, xs_padded: Sequence[torch.Tensor],
                   lengths: Sequence[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Variable-length allgather: shards padded to a common max; each
        shard gets (stacked [size, max, ...], stacked lengths [size, ...])."""
        g = self.allgather(xs_padded, tiled=False)
        lens = self.allgather(lengths, tiled=False)
        return list(zip(g, lens))

    def reducescatter(self, xs: Sequence[torch.Tensor], *,
                      tiled: bool = True) -> List[torch.Tensor]:
        """The sum over the axis, cut along dim 0: rank r keeps piece r."""
        n = self.get_size()
        a = self.mesh.axis_names.index(self.axis)
        sums = self.allreduce(xs)
        out = []
        for s, p in zip(sums, self.mesh.local_positions):
            r = self.mesh.coords(p)[a]
            out.append(torch.chunk(s, n, dim=0)[r] if tiled else s[r])
        return out

    def device_sendrecv(self, xs: Sequence[torch.Tensor],
                        dest_offset: int = 1) -> List[torch.Tensor]:
        """Ring neighbour exchange: rank r sends to r + ``dest_offset``
        (mod size), so each shard receives from r - ``dest_offset``."""
        n = self.get_size()
        a = self.mesh.axis_names.index(self.axis)
        return self._each(xs, lambda members, p, d: members[
            (self.mesh.coords(p)[a] - dest_offset) % n].to(d))

    def alltoall(self, xs: Sequence[torch.Tensor], *, split_axis: int = 0,
                 concat_axis: int = 0) -> List[torch.Tensor]:
        """Each shard cuts its tensor into size pieces along ``split_axis``
        and rank r gets every shard's piece r, concatenated in rank order
        along ``concat_axis``."""
        n = self.get_size()
        a = self.mesh.axis_names.index(self.axis)

        def combine(members, p, d):
            r = self.mesh.coords(p)[a]
            return torch.cat([torch.chunk(m, n, dim=split_axis)[r].to(d) for m in members],
                             dim=concat_axis)

        return self._each(xs, combine)

    def barrier_value(self) -> List[torch.Tensor]:
        """A barrier token: the sum of a one from every shard."""
        return self.allreduce([torch.ones((), device=d) for d in self.devices])

    # -- host-side ---------------------------------------------------------
    def sync_stream(self, *tensors) -> None:
        """Block until the work queued on the shards' devices (or on the
        devices of ``tensors``) has finished; a cancellation point, as
        ``Resources.sync``."""
        from raft_tpu_torch.core import interruptible as _intr

        _intr.check()
        devices = {t.device for t in tensors if isinstance(t, torch.Tensor)} or set(self.devices)
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        _intr.check()


def local_comms(n_devices: Optional[int] = None,
                devices: Optional[Sequence[DeviceLike]] = None) -> Comms:
    """One-process communicator over local devices (default: every visible
    CUDA device) — the nccl_clique analog (ref: comms/nccl_clique.hpp)."""
    return Comms(make_mesh(n_devices, devices=devices))


# ---- collective self-tests ------------------------------------------------
# The reference exposes runnable collective self-tests for cluster
# validation (ref: comms/comms_test.hpp:33-107).  Each returns True iff the
# collective produced the expected value on every shard of this process
# (in a multi-process mesh each process checks its own shards).

def _all(flags) -> bool:
    return all(bool(f) for f in flags)


def _scalars(comms: Comms, values) -> List[torch.Tensor]:
    return [torch.tensor(float(v), dtype=torch.float32, device=d)
            for v, d in zip(values, comms.devices)]


def perform_test_comms_allreduce(comms: Comms) -> bool:
    n = comms.get_size()
    got = comms.allreduce(_scalars(comms, [1.0] * len(comms.devices)))
    return _all(g == n for g in got)


def perform_test_comms_bcast(comms: Comms, root: int = 0) -> bool:
    mine = _scalars(comms, [42.0 if r == root else 0.0 for r in comms.ranks()])
    return _all(g == 42.0 for g in comms.bcast(mine, root))


def perform_test_comms_allgather(comms: Comms) -> bool:
    n = comms.get_size()
    mine = [t[None] for t in _scalars(comms, comms.ranks())]
    return _all(torch.equal(g, torch.arange(n, dtype=torch.float32, device=g.device))
                for g in comms.allgather(mine))


def perform_test_comms_reduce(comms: Comms, root: int = 0) -> bool:
    n = comms.get_size()
    got = comms.reduce(_scalars(comms, [1.0] * len(comms.devices)), root)
    return _all(g == n for g in got)


def perform_test_comms_reducescatter(comms: Comms) -> bool:
    n = comms.get_size()
    got = comms.reducescatter([torch.ones(n, device=d) for d in comms.devices])
    return _all(bool((g == n).all()) for g in got)


def perform_test_comms_send_recv(comms: Comms) -> bool:
    n = comms.get_size()
    got = comms.device_sendrecv(_scalars(comms, comms.ranks()))
    return _all(g == (r - 1) % n for g, r in zip(got, comms.ranks()))


def perform_test_comms_allgatherv(comms: Comms, max_len: int = 4) -> bool:
    """Rank r contributes r + 1 valid elements of value r, padded to
    ``max_len``; every rank must reconstruct the whole ragged set (ref:
    comms_t::allgatherv, comms/comms_test.hpp test_collective_allgatherv)."""
    n = comms.get_size()
    vals, lens = [], []
    for r, d in zip(comms.ranks(), comms.devices):
        v = torch.full((max_len,), float("nan"), device=d)
        v[:r + 1] = float(r)
        vals.append(v)
        lens.append(torch.tensor([r + 1], dtype=torch.int32, device=d))
    ok = True
    for g, ln in comms.allgatherv(vals, lens):
        for r in range(n):
            m = int(ln[r, 0])
            ok &= m == r + 1 and bool((g[r, :m] == float(r)).all())
    return ok


def perform_test_comm_split(comms: Comms, axis: str) -> bool:
    """Collectives on a split sub-communicator reduce only over that axis
    (ref: comms_t::comm_split + sub_comms resource)."""
    sub = comms.comm_split(axis)
    n_sub = sub.get_size()
    got = sub.allreduce(_scalars(sub, [1.0] * len(sub.devices)))
    return _all(g == n_sub for g in got)
