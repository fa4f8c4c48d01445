"""pylibraft.distance (counterpart of ``raft_tpu.compat.pylibraft.distance``):
``pairwise_distance``, ``fused_l2_nn_argmin``, ``fused_distance_nn_argmin``."""

from __future__ import annotations

from typing import Optional

from raft_tpu_torch.compat.pylibraft.common import DeviceResources, on_device, resources_of
from raft_tpu_torch.compat.pylibraft.config import convert_output
from raft_tpu_torch.distance import fused_nn as _fused
from raft_tpu_torch.distance import pairwise as _pairwise

DISTANCE_TYPES = sorted(_pairwise.DISTANCE_TYPES)


def pairwise_distance(X, Y, metric="euclidean", p=2.0, handle: Optional[DeviceResources] = None):
    x = on_device(X, handle)
    # X is Y stays so, for the exact zero diagonal
    out = _pairwise.pairwise_distance(x, None if Y is X else on_device(Y, handle),
                                      metric=metric, p=p, res=resources_of(handle))
    return convert_output(out)


def fused_l2_nn_argmin(X, Y, handle: Optional[DeviceResources] = None):
    out = _fused.fused_l2_nn_argmin(on_device(X, handle), on_device(Y, handle),
                                    res=resources_of(handle))
    return convert_output(out)


def fused_distance_nn_argmin(X, Y, metric="euclidean", handle: Optional[DeviceResources] = None):
    out = _fused.fused_distance_nn_argmin(on_device(X, handle), on_device(Y, handle),
                                          metric=metric, res=resources_of(handle))
    return convert_output(out)
