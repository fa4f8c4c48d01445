"""Combinatorial solvers (counterpart of ``raft_tpu.solver``)."""

from raft_tpu_torch.solver.linear_assignment import linear_assignment

__all__ = ["linear_assignment"]
