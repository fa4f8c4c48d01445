"""Systematic argument validation — the RAFT_EXPECTS / raft::exception
analog (ref: cpp/include/raft/core/error.hpp — RAFT_EXPECTS, RAFT_FAIL,
raft::exception with collected backtrace).

The reference guards every public entry with ``RAFT_EXPECTS(cond, fmt, ...)``
raising ``raft::logic_error``. Here the same discipline is a set of small
helpers raising :class:`RaftError` subtypes, so callers can catch one
exception family across the whole library while tests can assert on the
specific subtype.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence


class RaftError(Exception):
    """Base of all raft_tpu validation/runtime errors (ref: core/error.hpp
    raft::exception)."""


class LogicError(RaftError, ValueError):
    """Precondition violation (ref: raft::logic_error via RAFT_EXPECTS)."""


def expects(condition: bool, message: str) -> None:
    """RAFT_EXPECTS: raise LogicError when ``condition`` is false."""
    if not condition:
        raise LogicError(message)


def fail(message: str) -> None:
    """RAFT_FAIL: unconditional logic error."""
    raise LogicError(message)


def check_matrix(
    x,
    name: str = "input",
    *,
    ndim: int = 2,
    min_rows: int = 0,
    dtypes: Optional[Iterable] = None,
) -> None:
    """Validate an array argument's rank / row count / dtype."""
    expects(
        hasattr(x, "ndim") and x.ndim == ndim,
        f"{name} must be a rank-{ndim} array, got "
        f"{getattr(x, 'shape', type(x).__name__)}",
    )
    if min_rows:
        expects(
            x.shape[0] >= min_rows,
            f"{name} needs at least {min_rows} rows, got {x.shape[0]}",
        )
    if dtypes is not None:
        names = {str(d) for d in dtypes}
        expects(
            str(x.dtype) in names,
            f"{name} dtype {x.dtype} not in supported set {sorted(names)}",
        )


def check_same_cols(x, y, xname: str = "x", yname: str = "y") -> None:
    expects(
        x.shape[-1] == y.shape[-1],
        f"{xname} and {yname} must share the feature dimension: "
        f"{x.shape} vs {y.shape}",
    )


def check_in(value, allowed: Sequence, name: str = "argument") -> None:
    expects(
        value in allowed,
        f"{name} must be one of {sorted(map(str, allowed))}, got {value!r}",
    )


def check_positive(value: int, name: str = "argument") -> None:
    expects(value > 0, f"{name} must be positive, got {value}")
