"""Index registry (counterpart of ``raft_tpu.serve.registry``): named,
versioned indexes with atomic hot-swap.

Queries resolve a name to a :class:`~raft_tpu_torch.serve.mutation.
MutableIndex` once per dispatched batch, so a swap is atomic at batch
granularity: every row of a batch comes from one index version, and
in-flight batches keep the old version alive by reference until they
finish.  Snapshots write one file per index (``MutableIndex.save``) plus a
manifest binding names to versions (``core.serialize``, raft_tpu's
format), so restore round-trips tombstones and side buffers.
A :class:`~raft_tpu_torch.serve.shard.ShardedIndex` registers and
hot-swaps the same way (it is immutable: mutate the source and swap in a
re-shard); the registry refuses anything else.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.obs import events as obs_events
from raft_tpu_torch.serve.mutation import MutableIndex
from raft_tpu_torch.serve.shard import ShardedIndex

_MANIFEST_VERSION = 1
_MANIFEST_NAME = "MANIFEST"


def _check_index(index) -> None:
    if not isinstance(index, (MutableIndex, ShardedIndex)):
        raise TypeError(
            f"registry holds MutableIndex or ShardedIndex, got {type(index)!r}; "
            "wrap built indexes with MutableIndex(index) or "
            "ShardedIndex.from_index(index)"
        )


class IndexRegistry:
    """Thread-safe name → (index, version) map with atomic replacement."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, Tuple[MutableIndex, int]] = {}
        # weak history of every version ever bound: the live-buffer
        # accounting (obs.cost.refresh_live_buffer_gauges) walks this to
        # tell "swapped out and freed" from "swapped out and leaked" —
        # weak refs so the history itself never pins an old version
        self._history: "weakref.WeakValueDictionary[Tuple[str, int], MutableIndex]" = (
            weakref.WeakValueDictionary()
        )

    # -- registration / swap -------------------------------------------------
    def register(
        self, name: str, index: MutableIndex, *, version: Optional[int] = None
    ) -> int:
        """Bind ``name`` to ``index`` atomically; returns the new version.

        Re-registering an existing name IS the hot-swap: the version
        auto-increments (unless given) and readers see either the old or
        the new index, never a mix.
        """
        _check_index(index)
        with self._lock:
            prev = self._entries.get(name)
            if version is None:
                version = prev[1] + 1 if prev is not None else 1
            # tuple replacement is a single reference store — atomic for
            # readers holding no lock
            self._entries[name] = (index, version)
            self._history[(name, version)] = index
        # context event, published outside the lock: annotates any open
        # incident so "quality degraded right after version 7 went live"
        # reads off one timeline.  First-time registration is bootstrap,
        # not a swap — no event.
        if prev is not None:
            obs_events.publish(
                "registry_swap",
                index=name, version=version, prev_version=prev[1],
            )
        return version

    def swap(self, name: str, index: MutableIndex) -> int:
        """Hot-swap an existing name; raises KeyError if unknown."""
        _check_index(index)
        with self._lock:
            if name not in self._entries:
                raise KeyError(f"no index named {name!r} to swap")
            version = self._entries[name][1] + 1
            self._entries[name] = (index, version)
            self._history[(name, version)] = index
        obs_events.publish(
            "registry_swap",
            index=name, version=version, prev_version=version - 1,
        )
        return version

    def unregister(self, name: str) -> None:
        with self._lock:
            del self._entries[name]

    # -- resolution ----------------------------------------------------------
    def get(self, name: str) -> MutableIndex:
        with self._lock:
            return self._entries[name][0]

    def get_versioned(self, name: str) -> Tuple[MutableIndex, int]:
        """(index, version) resolved atomically — batch-dispatch entry."""
        with self._lock:
            return self._entries[name]

    def version(self, name: str) -> int:
        with self._lock:
            return self._entries[name][1]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def live_versions(self) -> Dict[Tuple[str, int], MutableIndex]:
        """Every (name, version) whose index object is still reachable —
        current versions plus any swapped-out version something still
        pins (an in-flight batch, or a leak)."""
        with self._lock:
            return dict(self._history)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- persistence ---------------------------------------------------------
    def snapshot(self, directory: str) -> None:
        """Write every index + a name→version manifest under ``directory``."""
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            entries = dict(self._entries)
        scalars = {"count": len(entries)}
        for i, name in enumerate(sorted(entries)):
            index, version = entries[name]
            scalars[f"name_{i}"] = name
            scalars[f"version_{i}"] = version
            index.save(os.path.join(directory, f"{name}.idx"))
        ser.save_tree(
            os.path.join(directory, _MANIFEST_NAME),
            "serve_registry", _MANIFEST_VERSION, scalars, {},
        )

    @classmethod
    def restore(cls, directory: str, *, res=None) -> "IndexRegistry":
        """Load a :meth:`snapshot` onto ``res``'s device (the card unless
        the caller asks for the CPU)."""
        scalars, _ = ser.load_tree(
            os.path.join(directory, _MANIFEST_NAME),
            "serve_registry", _MANIFEST_VERSION,
        )
        reg = cls()
        for i in range(int(scalars["count"])):
            name = scalars[f"name_{i}"]
            version = int(scalars[f"version_{i}"])
            index = MutableIndex.load(os.path.join(directory, f"{name}.idx"), res=res)
            reg.register(name, index, version=version)
        return reg
