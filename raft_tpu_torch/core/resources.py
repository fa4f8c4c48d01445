"""Resources: the device and workspace budget every entry point runs with
(counterpart of ``raft_tpu.core.resources``).

``Resources(device=...)`` defaults to ``"cuda"``.  Reading ``.device``
on a machine without a CUDA device raises unless the caller asked for the
CPU, so no entry point quietly falls back to the CPU.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import numpy as np
import torch


class Resources:
    """Device + workspace byte budget used by tiled algorithms to size
    their tiles (the role of raft's workspace memory resource)."""

    def __init__(
        self,
        device: Union[str, torch.device] = "cuda",
        workspace_limit_bytes: int = 256 * 1024 * 1024,
        seed: int = 0,
    ):
        self._device = torch.device(device)
        self.workspace_limit_bytes = int(workspace_limit_bytes)
        self._seed = int(seed)
        self._key_counter = 0
        self._lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "raft_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass Resources(device='cpu') to run on the CPU"
            )
        return self._device

    def workspace_rows(self, row_bytes: int, cap: int = 1 << 16) -> int:
        """How many rows of ``row_bytes`` fit in the workspace budget."""
        n = max(1, self.workspace_limit_bytes // max(1, row_bytes))
        return int(min(n, cap))

    def prng_key(self) -> torch.Generator:
        """A fresh ``torch.Generator`` on this device, seeded from (seed,
        counter): the counterpart of raft_tpu's ``prng_key()`` stream, so
        one Resources object gives the same sequence of generators on every
        run (not raft_tpu's threefry numbers)."""
        with self._lock:
            c = self._key_counter
            self._key_counter += 1
        return stream_generator(self._seed, c, self.device)

    def reseed(self, seed: int) -> None:
        with self._lock:
            self._seed = int(seed)
            self._key_counter = 0


#: raft's ``device_resources`` name for the same handle
DeviceResources = Resources


def stream_generator(seed: int, counter: int, device) -> torch.Generator:
    """The generator of draw ``counter`` of the stream seeded by ``seed``."""
    mixed = int(np.random.SeedSequence([int(seed), int(counter)]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


_default: Optional[Resources] = None
_default_lock = threading.Lock()


def default_resources() -> Resources:
    """Process-wide default Resources (``cuda``), created on first use."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Resources()
        return _default


def set_default_resources(res: Resources) -> None:
    """Replace the process-wide default Resources."""
    global _default
    with _default_lock:
        _default = res


def ensure(res: Optional[Resources]) -> Resources:
    """Resolve an optional resources argument."""
    return res if res is not None else default_resources()


def resolve_device(res=None, *inputs) -> torch.device:
    """Where a function whose raft_tpu counterpart takes no ``res`` runs:
    ``res`` when given (a Resources, a device or its name); else the device
    of the first tensor among ``inputs``; else the default Resources' (cuda,
    which raises without a card)."""
    if isinstance(res, Resources):
        return res.device
    if res is not None:
        return Resources(device=res).device
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
    return default_resources().device


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor of its own dtype.  Two-byte void arrays
    (``|V2``: what ``np.save`` writes for a bfloat16 array, as raft_tpu's
    bf16 lists are saved) and ml_dtypes' bfloat16 are read as bfloat16."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _note_copy(t: torch.Tensor, device) -> None:
    """Count a host↔device copy in ``obs.device_events`` (nothing for a
    copy that stays on one side)."""
    device = torch.device(device)
    if (t.device.type == "cpu") != (device.type == "cpu"):
        from raft_tpu_torch.obs import device_events

        device_events.record_copy(t.device, device, t.numel() * t.element_size())


def to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device``, keeping its dtype."""
    if isinstance(x, np.ndarray):
        x = from_numpy(x)
    x = torch.as_tensor(x)
    _note_copy(x, device)
    return x.to(device=device)


def as_f32(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as an f32 tensor on ``device`` (no copy when
    it already is one)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    x = torch.as_tensor(x)
    _note_copy(x, device)
    return x.to(device=device, dtype=torch.float32)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host (bf16 as f32: numpy has no
    bf16)."""
    _note_copy(t, "cpu")
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()
