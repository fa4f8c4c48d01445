"""NumPy-format serialization with version-stamped headers — byte-compatible
with ``raft_tpu.core.serialize``, so an index saved by raft_tpu loads here
and the other way round.

Layout: magic, kind, version, then named scalars and named ``.npy`` arrays
(each in sorted name order).  Tensors are staged through host numpy.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict

import numpy as np
import torch

MAGIC = b"RAFTTPU\x00"


def serialize_scalar(fh: BinaryIO, value) -> None:
    """Write a scalar with a one-byte type tag + fixed-width payload."""
    if isinstance(value, (bool, np.bool_)):
        fh.write(b"b")
        fh.write(struct.pack("<q", int(value)))
    elif isinstance(value, (int, np.integer)):
        fh.write(b"i")
        fh.write(struct.pack("<q", int(value)))
    elif isinstance(value, (float, np.floating)):
        fh.write(b"f")
        fh.write(struct.pack("<d", float(value)))
    elif isinstance(value, str):
        data = value.encode()
        fh.write(b"s")
        fh.write(struct.pack("<q", len(data)))
        fh.write(data)
    else:
        raise TypeError(f"unsupported scalar type {type(value)}")


def deserialize_scalar(fh: BinaryIO):
    tag = fh.read(1)
    if tag == b"b":
        return bool(struct.unpack("<q", fh.read(8))[0])
    if tag == b"i":
        return int(struct.unpack("<q", fh.read(8))[0])
    if tag == b"f":
        return float(struct.unpack("<d", fh.read(8))[0])
    if tag == b"s":
        n = struct.unpack("<q", fh.read(8))[0]
        return fh.read(n).decode()
    raise ValueError(f"bad scalar tag {tag!r}")


def serialize_array(fh: BinaryIO, arr) -> None:
    """Write one array in standard .npy format (host-staged)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        # numpy has no bfloat16: its two bytes go out as |V2, as np.save
        # writes raft_tpu's bfloat16 arrays (read back by
        # core.resources.from_numpy)
        arr = (t.view(torch.int16).numpy().view(np.dtype("V2")) if t.dtype == torch.bfloat16
               else t.numpy())
    np.save(fh, np.asarray(arr), allow_pickle=False)


def deserialize_array(fh: BinaryIO) -> np.ndarray:
    return np.load(fh, allow_pickle=False)


def write_header(fh: BinaryIO, kind: str, version: int) -> None:
    fh.write(MAGIC)
    serialize_scalar(fh, kind)
    serialize_scalar(fh, version)


def read_header(fh: BinaryIO, expected_kind: str, expected_version: int) -> int:
    magic = fh.read(len(MAGIC))
    if magic != MAGIC:
        raise ValueError("not a raft_tpu serialized file (bad magic)")
    kind = deserialize_scalar(fh)
    if kind != expected_kind:
        raise ValueError(f"expected serialized {expected_kind!r}, found {kind!r}")
    version = deserialize_scalar(fh)
    if version != expected_version:
        raise ValueError(
            f"serialization version mismatch for {kind!r}: "
            f"file={version} supported={expected_version}"
        )
    return version


def save_tree(path_or_fh, kind: str, version: int, scalars: Dict[str, Any],
              arrays: Dict[str, Any]) -> None:
    """Save an index as (header, named scalars, named arrays)."""

    def _write(fh):
        write_header(fh, kind, version)
        serialize_scalar(fh, len(scalars))
        for name in sorted(scalars):
            serialize_scalar(fh, name)
            serialize_scalar(fh, scalars[name])
        serialize_scalar(fh, len(arrays))
        for name in sorted(arrays):
            serialize_scalar(fh, name)
            serialize_array(fh, arrays[name])

    if isinstance(path_or_fh, (str, bytes)):
        with open(path_or_fh, "wb") as fh:
            _write(fh)
    else:
        _write(path_or_fh)


def load_tree(path_or_fh, kind: str, version: int):
    """Load (scalars, numpy arrays) saved by :func:`save_tree`."""

    def _read(fh):
        read_header(fh, kind, version)
        scalars = {}
        for _ in range(deserialize_scalar(fh)):
            name = deserialize_scalar(fh)
            scalars[name] = deserialize_scalar(fh)
        arrays = {}
        for _ in range(deserialize_scalar(fh)):
            name = deserialize_scalar(fh)
            arrays[name] = deserialize_array(fh)
        return scalars, arrays

    if isinstance(path_or_fh, (str, bytes)):
        with open(path_or_fh, "rb") as fh:
            return _read(fh)
    return _read(path_or_fh)
