"""PyTorch / CUDA port of raft_tpu for NVIDIA Hopper (H100).

Mirrors ``raft_tpu``'s module layout and public names.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (or a CPU
``Resources``); without a card they raise instead of quietly using the CPU.

Every TPU kernel on the ported path has a hand-written CUDA C++ kernel under
``csrc/`` (built with ``nvcc`` for ``sm_90a`` on first use, bound with
``ctypes``) and a plain PyTorch version beside its wrapper.  A CUDA tensor
inside a kernel's envelope goes to the kernel, and one outside it raises; a
CPU tensor goes to the plain version.

Scores are f32 at full precision: TF32 is switched off for matmuls and
cuDNN on import, matching raft_tpu's ``Precision.HIGHEST``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
