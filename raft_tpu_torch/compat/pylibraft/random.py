"""pylibraft.random (counterpart of ``raft_tpu.compat.pylibraft.random``):
``rmat``.  The edges are drawn from ``torch.Generator(seed)`` on the
handle's device: the same distribution as raft_tpu's threefry draws, not
the same edges."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.compat.pylibraft.common import DeviceResources, resources_of
from raft_tpu_torch.compat.pylibraft.config import convert_output
from raft_tpu_torch.random import datagen as _datagen


def rmat(r_scale, c_scale, n_edges, theta=None, seed=12345,
         handle: Optional[DeviceResources] = None):
    res = resources_of(handle)
    gen = torch.Generator(device=res.device).manual_seed(int(seed))
    out = _datagen.rmat(gen, int(r_scale), int(c_scale), int(n_edges),
                        theta=None if theta is None else np.asarray(theta), res=res)
    return convert_output(out)
