"""One view of the four indexes' search-effort knobs (counterpart of
``raft_tpu.neighbors.effort``).

Each index module defines its ``EffortSpec`` beside its ``SearchParams``
(ivf_flat / ivf_pq: ``n_probes`` + ``refine_ratio`` [+ ``lut_dtype``];
cagra: ``itopk_size`` + ``search_width``; brute_force: none).  This module
maps a params instance, or an index, back to the spec class that moves it,
so the bench and the serving layer never name a backend's fields.  Knob
values are host Python values.
"""

from __future__ import annotations

from typing import Optional

from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq

#: every backend's spec class, by backend name
SPECS = {
    "brute_force": brute_force.EffortSpec,
    "ivf_flat": ivf_flat.EffortSpec,
    "ivf_pq": ivf_pq.EffortSpec,
    "cagra": cagra.EffortSpec,
}

#: the names of the effort knobs
EFFORT_KNOBS = frozenset({"n_probes", "refine_ratio", "lut_dtype", "itopk_size", "search_width"})

_BY_PARAMS = {
    ivf_flat.SearchParams: ivf_flat.EffortSpec,
    ivf_pq.SearchParams: ivf_pq.EffortSpec,
    cagra.SearchParams: cagra.EffortSpec,
}


def spec_class_for_params(params_cls):
    """The EffortSpec class of a ``SearchParams`` class, or None."""
    return _BY_PARAMS.get(params_cls)


def spec_for_params(params, **extra):
    """The EffortSpec holding ``params``' knob values, or None."""
    spec_cls = _BY_PARAMS.get(type(params))
    return spec_cls.from_params(params, **extra) if spec_cls else None


def spec_for_index(index) -> Optional[object]:
    """The EffortSpec of an index: from its ``search_params`` when it carries
    them, the identity spec for brute force, else None."""
    base = getattr(index, "search_params", None)
    if base is not None:
        spec = spec_for_params(base)
        if spec is not None:
            return spec
    kind = getattr(index, "kind", None)
    if kind in SPECS:
        return SPECS[kind].from_params(base)
    if type(index).__module__.endswith("brute_force"):
        return brute_force.EffortSpec()
    return None


def backend_for_index(index) -> Optional[str]:
    """The backend name ("ivf_flat", ...) of an index, or None."""
    spec = spec_for_index(index)
    return spec.backend if spec is not None else None
