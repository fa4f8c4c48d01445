"""HOSTSYNC — device→host synchronization on the serving hot path
(counterpart of ``raft_tpu.analysis.checkers.hostsync``, with torch's
vocabulary of syncs).

The serving pipeline's throughput rests on dispatch staying asynchronous:
the only intended host syncs are the staged copy-out at the end of a
batch.  Anything else — ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``torch.cuda.synchronize``, an event's or a stream's
``.synchronize()``, ``np.asarray`` / ``np.array`` on a tensor, or
``float(x[0])`` — stalls the dispatch thread for a full device round trip
and serializes the pipeline.

The checker computes the set of functions statically reachable from the
hot-path roots (MicroBatcher dispatch / completion, the service and
mutable-index searches, the shard-merge and replica search paths) over
resolved call edges and flags every sync-shaped operation inside them.
Intended syncs carry an inline ``# raft-tpu: ignore[HOSTSYNC]`` with a
reason.  The receiver's type is not known statically: ``.tolist()`` on a
numpy array, or ``np.asarray`` of a host list, is flagged as well, and is
either moved off the path or suppressed with its reason.
"""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.model import Project, call_name, dotted

#: hot-path roots, matched by dotted-qualname suffix so a fixture package
#: triggers the same contract
ROOTS = (
    "serve.batcher.MicroBatcher._dispatch_locked",
    "serve.batcher.MicroBatcher._dispatch_pipelined",
    "serve.batcher.MicroBatcher._complete",
    "serve.service.SearchService.search",
    "serve.mutation.MutableIndex.search",
    "serve.shard.ShardedIndex.search",
    "serve.replica.ReplicaGroup.search",
)

#: method calls that force a sync (or a device→host copy) regardless of
#: receiver type
_SYNC_METHODS = {
    "item": "forces a device→host sync",
    "tolist": "forces a device→host sync",
    "cpu": "copies a device tensor to the host (a sync)",
    "numpy": "materializes a tensor on the host (a sync)",
    "synchronize": "blocks the host until device work completes",
}

#: import-resolved call targets that force a sync / host copy
_SYNC_CALLS = {
    "torch.cuda.synchronize": "blocks until device work completes",
    "numpy.asarray": "materializes a device tensor on host",
    "numpy.array": "materializes a device tensor on host",
    "numpy.copy": "materializes a device tensor on host",
}


def check(project: Project, result) -> None:
    roots = []
    for suffix in ROOTS:
        roots.extend(project.functions_matching(suffix))
    result.stats["hostsync_roots"] = len(roots)
    reachable = project.reachable(roots)
    result.stats["hostsync_reachable"] = len(reachable)

    seen = set()
    for fn in sorted(reachable, key=lambda f: f.qualname):
        mod = fn.module
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            key = (mod.path, getattr(node, "lineno", 0),
                   getattr(node, "col_offset", 0))
            if key in seen:
                continue
            msg = _classify(mod, node)
            if msg is None:
                continue
            seen.add(key)
            f = project.finding(
                "HOSTSYNC", mod, node, fn.qualname,
                f"{msg} inside hot-path function",
                suppressed_sink=result.suppressed,
            )
            if f is not None:
                result.findings.append(f)


def _classify(mod, call: ast.Call):
    if isinstance(call.func, ast.Attribute):
        name = call_name(mod, call)
        if name in _SYNC_CALLS:
            return f"`{dotted(call.func)}` {_SYNC_CALLS[name]}"
        attr = call.func.attr
        if attr in _SYNC_METHODS and not (name or "").startswith(
            ("os.", "time.", "threading.")
        ):
            return f"`.{attr}()` {_SYNC_METHODS[attr]}"
    elif isinstance(call.func, ast.Name):
        if call.func.id in ("float", "int", "bool") and call.args:
            arg = call.args[0]
            if isinstance(arg, ast.Subscript) and not _static_chain(arg):
                return (
                    f"`{call.func.id}()` on an indexed tensor concretizes "
                    "a device value"
                )
    return None


#: attributes that are host-side metadata — int(x.shape[1]) never syncs
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "nbytes"}


def _static_chain(node: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS
        for n in ast.walk(node)
    )
