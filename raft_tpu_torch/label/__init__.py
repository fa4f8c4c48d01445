"""Label utilities (counterpart of ``raft_tpu.label``)."""

from raft_tpu_torch.label.classlabels import get_classlabels, make_monotonic, relabel
from raft_tpu_torch.label.merge_labels import merge_labels

__all__ = ["get_classlabels", "make_monotonic", "relabel", "merge_labels"]
