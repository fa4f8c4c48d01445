"""Handle and device-array shims (counterpart of
``raft_tpu.compat.pylibraft.common``; pylibraft's ``common/``:
``DeviceResources``, ``device_ndarray``, ``cai_wrapper``,
``auto_sync_handle``, ``auto_convert_output``).

The handle wraps the port's ``Resources``; ``sync()`` waits for the
card.  Arrays go in without a host copy when they already live on the
card: a tensor as it is, a ``__cuda_array_interface__`` or ``__dlpack__``
object as a view of its memory."""

from __future__ import annotations

import functools
import inspect
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import (
    Resources, default_resources, from_numpy, to_device, to_numpy)


class DeviceResources:
    """pylibraft's ``DeviceResources`` handle over a port ``Resources``
    (on ``device``, by default the default Resources' device: cuda)."""

    def __init__(self, workspace_limit_bytes: int = 256 * 1024 * 1024, *, device=None):
        self.res = Resources(device=device if device is not None else default_resources()._device,
                             workspace_limit_bytes=workspace_limit_bytes)

    def sync(self) -> None:
        """Wait until the work queued on the handle's device is done (a
        cancellation point, as ``Resources.sync``)."""
        self.res.sync()


#: pylibraft's older name of the handle
Handle = DeviceResources


def _tensor(x) -> torch.Tensor:
    """``x`` as a tensor where it lives, without a copy where it can be
    viewed."""
    if isinstance(x, device_ndarray):
        return x.array
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, np.ndarray):
        return from_numpy(x)
    if hasattr(x, "__cuda_array_interface__"):
        return torch.as_tensor(x, device="cuda")
    if hasattr(x, "__dlpack__"):
        return torch.from_dlpack(x)
    return from_numpy(np.asarray(x))


def to_device_array(x, device=None) -> torch.Tensor:
    """A numpy array, tensor, ``device_ndarray`` or
    ``__cuda_array_interface__`` / ``__dlpack__`` object as a tensor on
    ``device`` (None: where it lives).  Memory already on ``device`` is
    taken as it is (same ``data_ptr``)."""
    t = _tensor(x)
    return t if device is None else to_device(t, torch.device(device))


class device_ndarray:
    """A device array owner (pylibraft's ``device_ndarray``), backed by a
    tensor on the card (or on ``device``), exposing
    ``__cuda_array_interface__`` there."""

    def __init__(self, np_arr, *, device=None):
        dev = device if device is not None else default_resources().device
        self._array = to_device_array(np_arr, dev)

    @classmethod
    def empty(cls, shape, dtype=np.float32, order="C", *, device=None):
        if order != "C":
            raise ValueError("device_ndarray holds row-major arrays only")
        return cls(np.empty(shape, dtype), device=device)

    @property
    def shape(self):
        return tuple(self._array.shape)

    @property
    def dtype(self):
        return np.dtype(to_numpy(self._array[:0]).dtype)

    @property
    def __cuda_array_interface__(self):
        return self._array.__cuda_array_interface__

    def copy_to_host(self) -> np.ndarray:
        return to_numpy(self._array)

    def __array__(self, dtype=None, copy=None):
        out = self.copy_to_host()
        return out if dtype is None else out.astype(dtype)

    @property
    def array(self) -> torch.Tensor:
        return self._array


class cai_wrapper:
    """Array-attribute wrapper (pylibraft's ``cai_wrapper``): the
    ``dtype`` / ``shape`` / ``c_contiguous`` surface of any array-like
    :func:`to_device_array` takes."""

    def __init__(self, x):
        self._array = to_device_array(x)

    @property
    def dtype(self):
        return np.dtype(to_numpy(self._array[:0]).dtype)

    @property
    def shape(self):
        return tuple(self._array.shape)

    @property
    def c_contiguous(self) -> bool:
        return self._array.is_contiguous()

    @property
    def array(self) -> torch.Tensor:
        return self._array


#: the host-array twin (pylibraft's ``ai_wrapper``)
ai_wrapper = cai_wrapper


def auto_sync_handle(fn):
    """Decorator: give the call a handle when it has none, and sync that
    handle after the call (pylibraft's ``auto_sync_handle``).  A handle
    passed by position is honoured through signature binding."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        bound = sig.bind_partial(*args, **kwargs)
        created = bound.arguments.get("handle") is None
        if created:
            bound.arguments["handle"] = DeviceResources()
        out = fn(*bound.args, **bound.kwargs)
        if created:
            bound.arguments["handle"].sync()
        return out

    return wrapper


def auto_convert_output(fn):
    """Decorator: apply ``config.set_output_as`` to the tensors a call
    returns (pylibraft's ``auto_convert_output``); tuples keep their type
    (NamedTuples too), lists and dicts are walked."""
    from raft_tpu_torch.compat.pylibraft import config

    def _conv(x):
        if isinstance(x, torch.Tensor):
            return config.convert_output(x)
        if isinstance(x, tuple):
            vals = [_conv(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        if isinstance(x, list):
            return [_conv(v) for v in x]
        if isinstance(x, dict):
            return {k: _conv(v) for k, v in x.items()}
        return x

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return _conv(fn(*args, **kwargs))

    return wrapper


def resources_of(handle: Optional[DeviceResources]) -> Resources:
    """The Resources a call with ``handle`` runs on (no handle: the
    default Resources)."""
    return handle.res if handle is not None else default_resources()


def on_device(x, handle: Optional[DeviceResources]) -> torch.Tensor:
    """An input as a tensor on the handle's device (no copy when it is
    there already)."""
    return to_device_array(x, resources_of(handle).device)
