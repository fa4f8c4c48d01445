"""Multi-process bootstrap — the raft-dask ``Comms`` analog (counterpart
of ``raft_tpu.comms.bootstrap``).

The reference bootstraps one process per GPU: a Dask client creates an NCCL
unique id, broadcasts it to every worker, each worker initializes its NCCL
rank and injects a ``std_comms`` into its handle
(ref: python/raft-dask/raft_dask/common/comms.py:39-243).  Here
:func:`initialize` calls ``torch.distributed.init_process_group`` with a
``tcp://`` rendezvous at the coordinator address (the nccl-uid analog), the
world size and the rank; :func:`global_mesh` then lays the processes'
shards out as one :class:`~raft_tpu_torch.comms.comms.Mesh`, process axis
outermost, whose verbs gather through the process group.

The backend follows the devices asked for: ``nccl`` when each rank holds
its own GPU, ``gloo`` on the CPU, and a raise when CUDA was asked for and
none is visible (no silent move to the CPU).  NCCL refuses two ranks on one
GPU, so a machine with one card runs the multi-process path as gloo CPU
processes.  The raft-dask lifecycle surface (session ids, ``init`` /
``destroy``, per-session worker state, ``local_handle``) is kept.
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch

from raft_tpu_torch.comms.comms import Comms, Mesh, make_mesh
from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.resources import Resources

_init_lock = threading.Lock()
_state: Dict[str, object] = {}


def is_initialized() -> bool:
    return bool(_state)


def _backend(device: str) -> str:
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "comms.initialize(device='cuda') but no CUDA device is visible; "
                "pass device='cpu' for gloo CPU processes")
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {device!r} for the process group")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Tuple[int, ...]] = None,
    *,
    device: str = "cuda",
    timeout_s: float = 300.0,
) -> None:
    """Join the process group (idempotent).

    ``coordinator_address`` (``host:port``) plays the role of the NCCL
    unique id: every process that dials it becomes a rank.  With all three
    arguments None the launcher contract is read instead:
    ``RAFT_TPU_COORDINATOR`` / ``RAFT_TPU_NUM_PROCS`` / ``RAFT_TPU_PROC_ID``
    (all three must be set together), as mpirun / srun export rank, size
    and rendezvous.  ``device`` picks the backend (``"cuda"``: NCCL, one
    GPU a rank, GPU ``local_device_ids[0]`` or ``process_id`` modulo the
    visible count; ``"cpu"``: gloo)."""
    import torch.distributed as dist

    with _init_lock:
        if _state:
            return
        if coordinator_address is None and num_processes is None and process_id is None:
            if not _env.has("RAFT_TPU_COORDINATOR"):
                raise RuntimeError(
                    "comms.initialize needs a coordinator address, a process "
                    "count and a process id, or RAFT_TPU_COORDINATOR / "
                    "RAFT_TPU_NUM_PROCS / RAFT_TPU_PROC_ID from the launcher")
            missing = [v for v in ("RAFT_TPU_NUM_PROCS", "RAFT_TPU_PROC_ID")
                       if not _env.has(v)]
            if missing:
                raise RuntimeError(
                    "RAFT_TPU_COORDINATOR is set but the launcher contract "
                    f"is incomplete: missing {missing} (all three of "
                    "RAFT_TPU_COORDINATOR/NUM_PROCS/PROC_ID must be "
                    "exported together)"
                )
            coordinator_address = _env.env_str("RAFT_TPU_COORDINATOR")
            num_processes = _env.env_int("RAFT_TPU_NUM_PROCS")
            process_id = _env.env_int("RAFT_TPU_PROC_ID")
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("coordinator_address, num_processes and process_id go together")
        backend = _backend(device)
        if backend == "nccl":
            ids = local_device_ids or (int(process_id) % torch.cuda.device_count(),)
            local = [torch.device("cuda", int(i)) for i in ids]
            torch.cuda.set_device(local[0])
        else:
            local = [torch.device("cpu")] * (len(local_device_ids) if local_device_ids else 1)
        import datetime

        addr = coordinator_address
        dist.init_process_group(
            backend, init_method=addr if "://" in addr else f"tcp://{addr}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        _state.update(backend=backend, local_devices=local)


def shutdown() -> None:
    import torch.distributed as dist

    with _init_lock:
        if _state:
            dist.destroy_process_group()
            _state.clear()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _state else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if _state else 1


def global_mesh(
    axis_names: Tuple[str, ...] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
    local_devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over every process's shards, process axis outermost (the analog
    of one std_comms spanning every worker's GPU, ref: raft-dask
    comms.py:172-212).  ``local_devices`` (default: the process's device
    from :func:`initialize`) lists this process's shards; every process
    must hold as many.  Without an initialized group: a one-process mesh
    over the visible CUDA devices."""
    if not _state:
        return make_mesh(axis_names=axis_names, shape=shape, devices=local_devices)
    devs = list(local_devices) if local_devices is not None else list(_state["local_devices"])
    return Mesh(devs, axis_names, shape, process_count=process_count(),
                process_index=process_index(), group=None, backend=_state["backend"])


# ---- per-session worker state (ref: raft-dask comms.py:247-268) -----------

_sessions: Dict[str, dict] = {}
_sessions_lock = threading.Lock()


def get_raft_comm_state(session_id: str) -> dict:
    """Per-session state dict, created on first access on this process
    (ref: raft-dask/common/comms.py:247 get_raft_comm_state)."""
    with _sessions_lock:
        return _sessions.setdefault(session_id, {})


def local_handle(session_id: str) -> Optional[Resources]:
    """The session's Resources on this process, or None if not init'd
    (ref: raft-dask/common/comms.py:262 local_handle)."""
    return get_raft_comm_state(session_id).get("handle")


@dataclass
class CommsCluster:
    """raft-dask ``Comms``-surface lifecycle object.

    ``init()`` joins the process group (when ``num_processes`` > 1, or
    when the launcher exported ``RAFT_TPU_COORDINATOR``), builds the global
    mesh, the collective facade and a per-session ``Resources`` handle on
    this process's first shard device, retrievable through
    ``local_handle(session_id)`` (ref: raft-dask comms.py:86-243).
    ``destroy()`` drops the session state; the process group itself is
    shared and ends with :func:`shutdown`."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    axis_names: Tuple[str, ...] = ("data",)
    mesh_shape: Optional[Tuple[int, ...]] = None
    session_id: str = field(default_factory=lambda: uuid.uuid4().hex)
    device: str = "cuda"
    local_devices: Optional[Sequence] = None

    def __post_init__(self):
        self._mesh: Optional[Mesh] = None
        self._comms: Optional[Comms] = None

    # -- lifecycle ---------------------------------------------------------
    def init(self) -> "CommsCluster":
        if self.num_processes is not None and self.num_processes > 1:
            initialize(self.coordinator_address, self.num_processes, self.process_id,
                       device=self.device)
        elif self.num_processes is None and _env.has("RAFT_TPU_COORDINATOR"):
            initialize(device=self.device)
        devices = self.local_devices
        if devices is None and not is_initialized() and self.device == "cpu":
            devices = ["cpu"]
        self._mesh = global_mesh(self.axis_names, self.mesh_shape, devices)
        self._comms = Comms(self._mesh, self.axis_names[0])
        state = get_raft_comm_state(self.session_id)
        handle = Resources(device=self._mesh.local_devices[0])
        handle.set_mesh(self._mesh)
        handle.set_comms(self._comms)
        state["handle"] = handle
        state["nranks"] = self._comms.get_size()
        state["rank"] = process_index()
        return self

    def destroy(self) -> None:
        with _sessions_lock:
            _sessions.pop(self.session_id, None)
        self._mesh = None
        self._comms = None

    # -- accessors ---------------------------------------------------------
    @property
    def mesh(self) -> Mesh:
        if self._mesh is None:
            raise RuntimeError("CommsCluster not initialized; call init()")
        return self._mesh

    @property
    def comms(self) -> Comms:
        if self._comms is None:
            raise RuntimeError("CommsCluster not initialized; call init()")
        return self._comms

    @property
    def handle(self) -> Resources:
        h = local_handle(self.session_id)
        if h is None:
            raise RuntimeError("CommsCluster not initialized; call init()")
        return h
