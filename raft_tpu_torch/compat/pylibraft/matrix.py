"""pylibraft.matrix (counterpart of ``raft_tpu.compat.pylibraft.matrix``):
``select_k``."""

from __future__ import annotations

from typing import Optional

from raft_tpu_torch.compat.pylibraft.common import DeviceResources, on_device
from raft_tpu_torch.compat.pylibraft.config import convert_output
from raft_tpu_torch.ops import matrix as _matrix


def select_k(dataset, k, select_min=True, handle: Optional[DeviceResources] = None):
    vals, idx = _matrix.select_k(on_device(dataset, handle), int(k), select_min=select_min)
    return convert_output(vals), convert_output(idx)
