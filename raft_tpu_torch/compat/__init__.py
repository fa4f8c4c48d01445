"""pylibraft-compatible API surface (counterpart of ``raft_tpu.compat``).

``raft_tpu_torch.compat.pylibraft`` mirrors the reference's Python package
layout (common / config / distance / matrix / cluster / neighbors /
random), so code written against pylibraft runs on the port by changing
its import root.  Inputs are numpy arrays, tensors, ``device_ndarray`` or
any object with ``__cuda_array_interface__`` or ``__dlpack__``; outputs
follow ``config.set_output_as`` (default: tensors on the card, as
pylibraft's default is device arrays).
"""

from raft_tpu_torch.compat import pylibraft

__all__ = ["pylibraft"]
