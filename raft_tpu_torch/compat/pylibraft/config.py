"""Global output conversion (counterpart of
``raft_tpu.compat.pylibraft.config``; pylibraft's ``set_output_as``):
"torch" (the default: tensors where the call ran, on the card by
default), "numpy" (host arrays) or a callable applied to each output
tensor.  raft_tpu's "jax" has no meaning here and raises."""

from __future__ import annotations

from typing import Callable, Union

import torch

from raft_tpu_torch.core.resources import to_numpy

_output_as: Union[str, Callable] = "torch"


def set_output_as(kind: Union[str, Callable]) -> None:
    global _output_as
    if not (kind in ("torch", "numpy") or callable(kind)):
        raise ValueError("set_output_as expects 'torch', 'numpy', or a callable")
    _output_as = kind


def get_output_as():
    return _output_as


def convert_output(x):
    """One output under the current setting (non-tensors pass through
    "torch" and "numpy")."""
    if _output_as == "torch":
        return x
    if _output_as == "numpy":
        return to_numpy(x) if isinstance(x, torch.Tensor) else x
    return _output_as(x)
