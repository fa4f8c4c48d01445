"""Distribution samplers (counterpart of ``raft_tpu.random.rng``): each
takes a ``torch.Generator`` first, draws on its device, and returns the
sample on ``res``'s device."""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.resources import Resources, ensure, stream_generator


class RngState:
    """Seed + subsequence counter: each :meth:`next_key` is the next
    generator of the stream (on ``device``, default cpu)."""

    def __init__(self, seed: int = 0, device="cpu"):
        self.seed = seed
        self.device = torch.device(device)
        self._counter = 0

    def next_key(self) -> torch.Generator:
        gen = stream_generator(self.seed, self._counter, self.device)
        self._counter += 1
        return gen


def _out(t: torch.Tensor, res: Optional[Resources]) -> torch.Tensor:
    return t.to(ensure(res).device)


def _rand(gen, shape, dtype=torch.float32):
    return torch.rand(tuple(shape), generator=gen, dtype=dtype, device=gen.device)


def _open_unit(gen, shape, dtype=torch.float32):
    """Uniform on (0, 1): the smallest positive float for a drawn 0."""
    u = _rand(gen, shape, dtype)
    return torch.clamp(u, min=torch.finfo(dtype).tiny)


def uniform(gen, shape, *, low=0.0, high=1.0, dtype=torch.float32, res=None):
    return _out(low + (high - low) * _rand(gen, shape, dtype), res)


def uniform_int(gen, shape, *, low=0, high=100, dtype=torch.int32, res=None):
    return _out(torch.randint(low, high, tuple(shape), generator=gen, device=gen.device,
                              dtype=dtype), res)


def normal(gen, shape, *, mu=0.0, sigma=1.0, dtype=torch.float32, res=None):
    z = torch.randn(tuple(shape), generator=gen, dtype=dtype, device=gen.device)
    return _out(mu + sigma * z, res)


def gumbel(gen, shape, *, mu=0.0, beta=1.0, dtype=torch.float32, res=None):
    g = -torch.log(-torch.log(_open_unit(gen, shape, dtype)))
    return _out(mu + beta * g, res)


def laplace(gen, shape, *, mu=0.0, scale=1.0, dtype=torch.float32, res=None):
    u = _open_unit(gen, shape, dtype) - 0.5
    return _out(mu - scale * torch.sign(u) * torch.log1p(-2.0 * u.abs()), res)


def lognormal(gen, shape, *, mu=0.0, sigma=1.0, dtype=torch.float32, res=None):
    return torch.exp(normal(gen, shape, mu=mu, sigma=sigma, dtype=dtype, res=res))


def exponential(gen, shape, *, lam=1.0, dtype=torch.float32, res=None):
    return _out(-torch.log(_open_unit(gen, shape, dtype)) / lam, res)


def rayleigh(gen, shape, *, sigma=1.0, dtype=torch.float32, res=None):
    u = torch.clamp(_rand(gen, shape, dtype), min=1e-12)
    return _out(sigma * torch.sqrt(-2.0 * torch.log(u)), res)


def bernoulli(gen, shape, *, prob=0.5, dtype=torch.bool, res=None):
    return _out((_rand(gen, shape) < prob).to(dtype), res)


def sample_without_replacement(gen, population: int, n_samples: int, *, weights=None,
                               res=None) -> torch.Tensor:
    """``n_samples`` distinct ids of ``range(population)``: uniform (a
    random permutation's head), or weighted by the Gumbel top-k trick."""
    if weights is None:
        return _out(torch.randperm(population, generator=gen, device=gen.device)[:n_samples],
                    res)
    w = torch.as_tensor(weights).to(device=gen.device, dtype=torch.float32)
    g = -torch.log(-torch.log(_open_unit(gen, (population,)))) + torch.log(
        torch.clamp(w, min=1e-30))
    return _out(torch.topk(g, n_samples).indices.to(torch.int32), res)


def permute(gen, n: int, *, res=None) -> torch.Tensor:
    """A random permutation of range(n)."""
    return _out(torch.randperm(n, generator=gen, device=gen.device), res)


def multi_variable_gaussian(gen, mean, cov, n_samples: int, *, res=None) -> torch.Tensor:
    """Samples of N(mean, cov) by the Cholesky factor of cov + 1e-8 I."""
    mean = torch.as_tensor(mean).to(gen.device)
    cov = torch.as_tensor(cov).to(device=gen.device, dtype=mean.dtype)
    d = mean.shape[0]
    chol = torch.linalg.cholesky(cov + 1e-8 * torch.eye(d, dtype=cov.dtype, device=cov.device))
    z = torch.randn((n_samples, d), generator=gen, dtype=mean.dtype, device=gen.device)
    return _out(mean[None, :] + z @ chol.T, res)
