"""Random number generation and synthetic data (counterpart of
``raft_tpu.random``).

Every sampler takes a ``torch.Generator`` where raft_tpu takes a threefry
key, draws on the generator's device and returns its result on ``res``'s
device (default: cuda).  The numbers are not raft_tpu's: the target is
distribution parity, not bitwise equality, as raft_tpu's own tests (and the
reference's) hold their generators.
"""

from raft_tpu_torch.random.rng import (
    RngState,
    bernoulli,
    exponential,
    gumbel,
    laplace,
    lognormal,
    multi_variable_gaussian,
    normal,
    permute,
    rayleigh,
    sample_without_replacement,
    uniform,
    uniform_int,
)
from raft_tpu_torch.random.datagen import make_blobs, make_regression, rmat

__all__ = [
    "RngState",
    "uniform",
    "uniform_int",
    "normal",
    "gumbel",
    "laplace",
    "lognormal",
    "exponential",
    "rayleigh",
    "bernoulli",
    "sample_without_replacement",
    "permute",
    "multi_variable_gaussian",
    "make_blobs",
    "make_regression",
    "rmat",
]
