"""The port's static analyzer (``raft_tpu_torch.analysis``): the port's
own tree has no unsuppressed finding; every rule fires on a small
torch-flavoured bad package this file writes into ``tmp_path`` (HOSTSYNC on
``.item()``, ``.cpu()`` and ``torch.cuda.synchronize`` under a serving
root) and every ``# raft-tpu: ignore[RULE]`` is honoured; the CLI's exit
codes and baseline round trip behave as raft_tpu's
(``tests/test_static_analysis.py``)."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from raft_tpu_torch.analysis import RULES, run_analysis
from raft_tpu_torch.analysis.checkers import envreg

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

BADPKG = {
    "__init__.py": "",
    "core/__init__.py": "",
    "core/trace.py": """
        def traced(name=None):
            def wrap(fn):
                return fn
            return wrap
    """,
    "core/env.py": """
        from dataclasses import dataclass

        @dataclass(frozen=True)
        class EnvVar:
            name: str
            kind: str
            default: str
            help: str

        KNOWN_VARS = (
            EnvVar("RAFT_TPU_FIXTURE_DIR", "str", "unset", "a directory"),
            EnvVar("RAFT_TPU_FIXTURE_UNDOCUMENTED", "int", "1", "not in the README"),
        )

        def env_str(name, default=None):
            return default

        def env_int(name, default=None):
            return default
    """,
    "config.py": """
        import os

        from badpkg.core import env

        CAP = os.environ.get("RAFT_TPU_FIXTURE_CAP")
        DIR = os.environ.get("RAFT_TPU_FIXTURE_DIR")  # raft-tpu: ignore[ENVREG] read before import
        WRONG = env.env_int("RAFT_TPU_FIXTURE_DIR")
        MISSING = env.env_str("RAFT_TPU_FIXTURE_NOWHERE")
    """,
    "locks.py": """
        import threading

        class Pair:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()
                self._pending = 0

            def ab(self):
                with self._a:
                    with self._b:
                        self._pending += 1

            def ba(self):
                with self._b:
                    with self._a:
                        pass

            def bump(self):
                self._pending = 2

            def bump_quietly(self):
                self._pending = 3  # raft-tpu: ignore[LOCKORDER] single-threaded reset
    """,
    "neighbors/__init__.py": """
        from badpkg.neighbors import flat

        __all__ = ["flat"]
    """,
    "neighbors/flat.py": """
        from badpkg.core.trace import traced

        def search(index, q, k):
            return q

        def build(x):  # raft-tpu: ignore[TRACED] a fixture's own control
            return x
    """,
    "serve/__init__.py": "",
    "serve/service.py": """
        from badpkg import kernels
        from badpkg.core.trace import traced

        class SearchService:
            def search(self, q, k):
                kernels.stamp_kernel_path("pallas")
                return q

            @traced("serve.explain")
            def explain(self, q):
                return q

            @traced("serve.explain")
            def swap(self, name, index):
                return index
    """,
    "kernels.py": """
        def stamp_kernel_path(path):
            return path
    """,
    "serve/batcher.py": """
        import numpy as np
        import torch

        class _Request:
            __slots__ = ("rows", "k", "fid", "priority", "deadline")

        class MicroBatcher:
            def _dispatch_locked(self, batch):
                n = batch.count.item()
                host = batch.out.cpu()
                torch.cuda.synchronize()
                arr = np.asarray(batch.out)
                self._stage(batch)
                return n, host, arr

            def _stage(self, batch):
                batch.event.synchronize()
                return batch.ids.numpy()

            def _complete(self, batch):
                return batch.ids.tolist()  # raft-tpu: ignore[HOSTSYNC] the intended copy-out

            def _dispatch_pipelined(self, batch):
                return batch
    """,
}

README = """
# badpkg

| variable | default | effect |
| --- | --- | --- |
| `RAFT_TPU_OUTSIDE_THE_SECTION` | x | raft_tpu's table: never read |

## PyTorch / H100 port

| variable | default | effect |
| --- | --- | --- |
| `RAFT_TPU_FIXTURE_DIR` | unset | a directory |
| `RAFT_TPU_FIXTURE_GONE` | unset | a stale row |

## Next section

| `RAFT_TPU_AFTER_THE_SECTION` | x | never read |
"""


@pytest.fixture(scope="module")
def badpkg(tmp_path_factory):
    base = tmp_path_factory.mktemp("fixture")
    for rel, src in BADPKG.items():
        path = base / "badpkg" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    (base / "README.md").write_text(README)
    return base / "badpkg"


@pytest.fixture(scope="module")
def fixture_result(badpkg):
    return run_analysis(root=str(badpkg))


@pytest.fixture(scope="module")
def clean_result():
    return run_analysis()


def _by_rule(result, rule):
    return ([f for f in result.findings if f.rule == rule],
            [f for f in result.suppressed if f.rule == rule])


def test_port_has_no_unsuppressed_findings(clean_result):
    rendered = "\n".join(f.render() for f in clean_result.sorted_findings())
    assert not clean_result.findings, rendered


def test_every_suppression_in_the_port_carries_a_reason():
    import re

    pat = re.compile(r"#\s*raft-tpu:\s*ignore\[[A-Z0-9_,\s]+\](.*)$")
    seen = 0
    for path in (REPO / "raft_tpu_torch").rglob("*.py"):
        if "analysis" in path.parts:   # the analyzer's own docs quote the syntax
            continue
        for line in path.read_text().splitlines():
            m = pat.search(line)
            if m:
                seen += 1
                assert len(m.group(1).strip()) >= 10, (path, line)
    assert seen >= 5


def test_discovery_is_not_vacuous(clean_result):
    stats = clean_result.stats
    assert stats["modules"] >= 130, stats
    assert stats["functions"] >= 1500, stats
    # MicroBatcher's three roots, the service's and the mutable index's
    # searches, and ShardedIndex.search (ReplicaGroup: ROADMAP item 7b)
    assert stats["hostsync_roots"] == 6, stats
    assert stats["hostsync_reachable"] >= 100, stats
    assert stats["lockorder_locks"] >= 30, stats
    assert stats["envreg_known_vars"] >= 70, stats
    assert stats["traced_entry_points"] >= 40, stats
    assert stats["traced_serve_entries_checked"] >= 25, stats
    assert stats["traced_batcher_classes"] == 1, stats
    assert stats["traced_kernel_path_stamps"] >= 10, stats


def test_rules_are_raft_tpus_but_recompile():
    from raft_tpu.analysis import RULES as JRULES

    assert set(RULES()) == set(JRULES()) - {"RECOMPILE"}


def test_every_rule_fires_on_the_fixture(fixture_result):
    assert {f.rule for f in fixture_result.findings} == set(RULES())


def test_hostsync_rule(fixture_result):
    findings, suppressed = _by_rule(fixture_result, "HOSTSYNC")
    on_root = [f for f in findings if f.symbol.endswith("MicroBatcher._dispatch_locked")]
    for what in ("`.item()`", "`.cpu()`", "torch.cuda.synchronize", "np.asarray"):
        assert any(what in f.message for f in on_root), (what, findings)
    # reached through a resolved call from the root
    staged = [f for f in findings if f.symbol.endswith("MicroBatcher._stage")]
    assert any("`.numpy()`" in f.message for f in staged), findings
    assert any("`.synchronize()`" in f.message for f in staged), findings
    assert any(".tolist()" in s.message and s.symbol.endswith("._complete")
               for s in suppressed), suppressed


def test_lockorder_rule(fixture_result):
    findings, suppressed = _by_rule(fixture_result, "LOCKORDER")
    assert any("lock-acquisition cycle" in f.message for f in findings), findings
    assert any("self._pending" in f.message and f.symbol.endswith(".bump")
               for f in findings), findings
    assert any(s.symbol.endswith(".bump_quietly") for s in suppressed), suppressed


def test_envreg_rule(fixture_result):
    findings, suppressed = _by_rule(fixture_result, "ENVREG")
    by_var = {f.symbol: f.message for f in findings}
    assert "direct os.environ.get" in by_var["RAFT_TPU_FIXTURE_CAP"]
    assert "not declared" in by_var["RAFT_TPU_FIXTURE_NOWHERE"]
    assert "disagrees with the registry" in by_var["RAFT_TPU_FIXTURE_DIR"]
    assert "missing from the README" in by_var["RAFT_TPU_FIXTURE_UNDOCUMENTED"]
    assert "README documents" in by_var["RAFT_TPU_FIXTURE_GONE"]
    # only the port's section of the README is reconciled
    assert "RAFT_TPU_OUTSIDE_THE_SECTION" not in by_var
    assert "RAFT_TPU_AFTER_THE_SECTION" not in by_var
    assert any(s.symbol == "RAFT_TPU_FIXTURE_DIR" for s in suppressed), suppressed


def test_readme_section_bounds(tmp_path):
    lines = README.splitlines(keepends=True)
    start, end = envreg._section(lines)
    inside = "".join(lines[start - 1:end - 1])
    assert "FIXTURE_GONE" in inside and "OUTSIDE" not in inside and "AFTER" not in inside
    assert envreg._section(["| `RAFT_TPU_X` | 1 | y |\n"]) == (1, 2)


def test_traced_rule(fixture_result):
    findings, suppressed = _by_rule(fixture_result, "TRACED")
    symbols = {f.symbol for f in findings}
    assert "badpkg.neighbors.flat.search" in symbols, findings
    assert "badpkg.serve.service.SearchService.search" in symbols, findings
    assert any("reused" in f.message for f in findings), findings
    assert any("'pallas'" in f.message for f in findings), findings
    assert any("open_span" in f.message for f in findings), findings
    assert any("req_id slot" in f.message for f in findings), findings
    assert any(s.symbol == "badpkg.neighbors.flat.build" for s in suppressed), suppressed


def test_suppressions_do_not_leak_into_findings(fixture_result):
    assert not ({s.id for s in fixture_result.suppressed}
                & {f.id for f in fixture_result.findings})
    assert len(fixture_result.suppressed) >= 4


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "raft_tpu_torch.analysis", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_cli_exit_codes(badpkg):
    bad = _cli("--root", str(badpkg))
    assert bad.returncode == 1, bad.stdout + bad.stderr
    usage = _cli("--rules", "NOSUCHRULE")
    assert usage.returncode == 2, usage.stdout + usage.stderr
    listing = _cli("--list-rules")
    assert listing.returncode == 0 and set(listing.stdout.split()) == set(RULES())
    ok = _cli()
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 finding(s)" in ok.stdout


def test_cli_baseline_roundtrip(badpkg, tmp_path):
    baseline = tmp_path / "baseline.json"
    wrote = _cli("--root", str(badpkg), "--write-baseline", str(baseline))
    assert wrote.returncode == 0, wrote.stdout + wrote.stderr
    gated = _cli("--root", str(badpkg), "--baseline", str(baseline), "--json")
    assert gated.returncode == 0, gated.stdout + gated.stderr
    payload = json.loads(gated.stdout)
    assert payload["findings"] == [] and payload["baselined"], payload
