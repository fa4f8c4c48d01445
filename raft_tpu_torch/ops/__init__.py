"""Dense primitives: matrix ops, linear algebra, the Lanczos solver and the
kernels' cost model (counterpart of ``raft_tpu.ops``)."""

from raft_tpu_torch.ops import cost, lanczos, linalg, matrix
from raft_tpu_torch.ops.matrix import select_k

__all__ = ["cost", "lanczos", "linalg", "matrix", "select_k"]
