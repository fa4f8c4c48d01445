"""Process-wide pooled Resources, one per CUDA device (counterpart of
``raft_tpu.core.manager``; the reference's
``device_resources_manager.hpp``).  Settings apply before a device's
handle is first made and freeze after it."""

from __future__ import annotations

import threading
from typing import Dict

import torch

from raft_tpu_torch.core.resources import Resources

_lock = threading.Lock()
_pool: Dict[int, Resources] = {}
_defaults = {"workspace_limit_bytes": 256 * 1024 * 1024, "seed": 0}
_frozen = False


def _set(key: str, value: int) -> None:
    with _lock:
        if _frozen:
            raise RuntimeError("device_resources_manager settings are frozen after first use")
        _defaults[key] = int(value)


def set_workspace_limit(limit_bytes: int) -> None:
    """The workspace budget of the handles made from now on."""
    _set("workspace_limit_bytes", limit_bytes)


def set_seed(seed: int) -> None:
    """The base seed of the handles made from now on (device i gets
    seed + i)."""
    _set("seed", seed)


def get_device_resources(device_id: int = 0) -> Resources:
    """The pooled Resources of CUDA device ``device_id``.  Raises without a
    card (there is no CPU handle to fall back to) and for an id past
    ``torch.cuda.device_count()``."""
    global _frozen
    with _lock:
        if device_id not in _pool:
            if not torch.cuda.is_available():
                raise RuntimeError("device_resources_manager: no CUDA device is available")
            count = torch.cuda.device_count()
            if not 0 <= device_id < count:
                raise ValueError(f"device_id {device_id} out of range ({count} CUDA devices)")
            _frozen = True  # only after validation: a bad id must not freeze
            _pool[device_id] = Resources(
                device=f"cuda:{device_id}",
                seed=_defaults["seed"] + device_id,
                workspace_limit_bytes=_defaults["workspace_limit_bytes"],
            )
        return _pool[device_id]


def reset() -> None:
    """Drop the pooled handles and unfreeze the settings (tests)."""
    global _frozen
    with _lock:
        _pool.clear()
        _frozen = False
