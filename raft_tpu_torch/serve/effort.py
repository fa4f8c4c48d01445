"""Single-writer search-effort arbitration for one served index
(counterpart of ``raft_tpu.serve.effort``).

:class:`EffortArbiter` is the one place that computes the effective
effort level and the derived ``SearchParams`` a dispatch uses
(``apply(index)``).  The autotuner is its only writer
(``set_autotune_level``, called by ``obs.autotune.Autotuner``);
the overload ladder is a clamp, read at apply time: effective level =
``max(autotune level, overload shed level)``, capped at the warmed ladder
depth.  Derived params are cached per ``(base params, level)``, and the
batcher's warmup runs every level in ``levels()``, so moving effort never
builds a kernel on the hot path.  One leaf lock guards the arbiter's own
fields only.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.serve.overload import OverloadConfig, derive_degraded_params


class EffortArbiter:
    """Arbitrates every actuator's search-effort intent for one index
    into a single effective ladder level and one derived params object.
    """

    def __init__(self, degraded=None, *, max_level: Optional[int] = None,
                 name: str = "default"):
        self.name = name
        #: overload ladder read as a clamp (may be None: no overload
        #: protection configured)
        self.degraded = degraded
        if max_level is None:
            cfg = degraded.config if degraded is not None \
                else OverloadConfig.from_env()
            max_level = cfg.max_degrade_level
        self.max_level = int(max_level)
        self._lock = threading.Lock()  # leaf lock: own fields only
        self._autotune_level = 0
        self._pin: Optional[int] = None
        self._derived: Dict[Tuple[int, int], object] = {}

    # -- ladder ---------------------------------------------------------

    def levels(self) -> Tuple[int, ...]:
        """Every effort level warmup must run (0 … max)."""
        return tuple(range(self.max_level + 1))

    @contextmanager
    def pinned(self, level: int):
        """Force an effective level, bypassing both writers (warmup
        ladders, tests)."""
        with self._lock:
            prev, self._pin = self._pin, int(level)
        try:
            yield
        finally:
            with self._lock:
                self._pin = prev

    def set_pin(self, level: Optional[int]) -> Optional[int]:
        """Operator pin: force the effective level until explicitly
        cleared with ``None`` — the persistent sibling of the scoped
        :meth:`pinned`.  Clamped to the warmed ladder; returns the stored
        pin."""
        with self._lock:
            if level is None:
                self._pin = None
            else:
                self._pin = max(0, min(int(level), self.max_level))
            return self._pin

    # -- the single writer ---------------------------------------------

    @property
    def autotune_level(self) -> int:
        with self._lock:
            return self._autotune_level

    def set_autotune_level(self, level: int) -> int:
        """The autotuner's intent — the one mutating entry point.
        Clamped to the warmed ladder; returns the stored level."""
        level = max(0, min(int(level), self.max_level))
        with self._lock:
            self._autotune_level = level
        return level

    # -- reads ----------------------------------------------------------

    def effective_level(self) -> int:
        """Arbitrated level: autotune intent floored by the overload
        shed level (clamp semantics), capped at the warmed ladder."""
        with self._lock:
            if self._pin is not None:
                return self._pin
            level = self._autotune_level
        if self.degraded is not None:
            level = max(level, self.degraded.level)
        return min(level, self.max_level)

    @traced("serve.effort.apply")
    def apply(self, index):
        """The search params the arbitrated level prescribes for
        ``index``, or None at full effort (callers fall back to the
        index's own).  Cached per (base params, level)."""
        level = self.effective_level()
        if level <= 0:
            return None
        base = getattr(index, "search_params", None)
        if base is None:
            return None
        key = (id(base), level)
        with self._lock:
            derived = self._derived.get(key)
        if derived is None:
            derived = derive_degraded_params(base, level)
            with self._lock:
                self._derived[key] = derived
        return derived

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            autotune = self._autotune_level
            pinned = self._pin
        degraded = self.degraded.level if self.degraded is not None else 0
        effective = self.effective_level()
        # who set the effective level — the attribution per-query explain
        # plans surface ("effort level and who set it")
        if pinned is not None:
            source = "pinned"
        elif effective <= 0:
            source = "full_effort"
        elif degraded > autotune:
            source = "overload_clamp"
        else:
            source = "autotune"
        return {
            "autotune_level": autotune,
            "degraded_level": degraded,
            "effective_level": effective,
            "max_level": self.max_level,
            "source": source,
        }
