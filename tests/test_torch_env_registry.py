"""The port's ``core.env`` registry against raft_tpu's: every
``RAFT_TPU_*`` name the port reads is declared with raft_tpu's type and
default, an undeclared read raises ``UnknownEnvVarError``, a read of
another type raises ``TypeError``, and the accessors parse values as
raft_tpu's do."""

import ast
import os
from pathlib import Path

import pytest
import torch

from raft_tpu.core import env as jenv
from raft_tpu_torch.core import env as tenv

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PORT = Path(__file__).resolve().parent.parent / "raft_tpu_torch"
ACCESSORS = ("env_str", "env_int", "env_float", "env_bool", "has", "raw")


def _literal_reads():
    """(accessor, name) of every accessor call in the port with a literal
    ``RAFT_TPU_*`` name, and the module constants those calls name."""
    out = set()
    for path in PORT.rglob("*.py"):
        tree = ast.parse(path.read_text())
        consts = {t.id: n.value.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                  for t in n.targets if isinstance(t, ast.Name)
                  and isinstance(n.value, ast.Constant) and isinstance(n.value.value, str)}
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ACCESSORS and node.args):
                continue
            arg = node.args[0]
            name = (arg.value if isinstance(arg, ast.Constant) else
                    consts.get(arg.id) if isinstance(arg, ast.Name) else
                    consts.get(arg.attr) if isinstance(arg, ast.Attribute) else None)
            if isinstance(name, str) and name.startswith("RAFT_TPU_"):
                out.add((node.func.attr, name))
    return out


def test_every_name_the_port_reads_is_declared_with_its_type():
    reads = _literal_reads()
    assert len({n for _, n in reads}) >= 60, len(reads)
    kinds = {"env_str": "str", "env_int": "int", "env_float": "float", "env_bool": "bool"}
    for accessor, name in reads:
        assert tenv.known(name), name
        if accessor in kinds:
            assert tenv._KNOWN[name].kind == kinds[accessor], (accessor, name)


def test_rows_carry_raft_types_and_defaults():
    raft = {v.name: v for v in jenv.KNOWN_VARS}
    assert len(tenv.KNOWN_VARS) == len({v.name for v in tenv.KNOWN_VARS})
    for v in tenv.KNOWN_VARS:
        assert v.name in raft, v.name
        assert (v.kind, v.default) == (raft[v.name].kind, raft[v.name].default), v.name
    # the multi-GPU settings of this slice are declared
    for name in ("RAFT_TPU_SHARD_MERGE_DTYPE", "RAFT_TPU_SHARD_CAGRA",
                 "RAFT_TPU_BUILD_REDUCE_DTYPE", "RAFT_TPU_COORDINATOR",
                 "RAFT_TPU_NUM_PROCS", "RAFT_TPU_PROC_ID"):
        assert tenv.known(name), name


@pytest.mark.parametrize("accessor", ACCESSORS)
def test_undeclared_name_raises(accessor, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_NOT_A_SETTING", "1")
    assert not tenv.known("RAFT_TPU_NOT_A_SETTING")
    with pytest.raises(tenv.UnknownEnvVarError, match="RAFT_TPU_NOT_A_SETTING"):
        getattr(tenv, accessor)("RAFT_TPU_NOT_A_SETTING")
    assert issubclass(tenv.UnknownEnvVarError, KeyError)


@pytest.mark.parametrize("accessor, name", [
    ("env_int", "RAFT_TPU_SLOW_QUERY_MS"),        # a float row
    ("env_str", "RAFT_TPU_PIPELINE_DEPTH"),       # an int row
    ("env_bool", "RAFT_TPU_FLIGHT_DIR"),          # a str row
    ("env_float", "RAFT_TPU_RAGGED"),             # a bool row
])
def test_type_mismatch_raises(accessor, name):
    with pytest.raises(TypeError, match="declared as"):
        getattr(tenv, accessor)(name)
    with pytest.raises(TypeError):
        getattr(jenv, accessor)(name)


@pytest.mark.parametrize("value", [None, "", "0", "1", "false", "FALSE", "no", "off", "yes",
                                   "on", "true", " 0 ", "2"])
def test_bool_parsing_matches_raft(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("RAFT_TPU_RAGGED", raising=False)
    else:
        monkeypatch.setenv("RAFT_TPU_RAGGED", value)
    for default in (False, True):
        assert tenv.env_bool("RAFT_TPU_RAGGED", default) == jenv.env_bool("RAFT_TPU_RAGGED",
                                                                           default)
    assert tenv.has("RAFT_TPU_RAGGED") == jenv.has("RAFT_TPU_RAGGED")
    assert tenv.raw("RAFT_TPU_RAGGED") == jenv.raw("RAFT_TPU_RAGGED")


@pytest.mark.parametrize("value", ["", " ", "7", "-3", "2.5", "x"])
def test_number_parsing_matches_raft(value, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PIPELINE_DEPTH", value)
    monkeypatch.setenv("RAFT_TPU_SLOW_QUERY_MS", value)
    for accessor, name in (("env_int", "RAFT_TPU_PIPELINE_DEPTH"),
                           ("env_float", "RAFT_TPU_SLOW_QUERY_MS")):
        try:
            want = getattr(jenv, accessor)(name, 11)
        except ValueError:
            with pytest.raises(ValueError, match="is not"):
                getattr(tenv, accessor)(name, 11)
        else:
            assert getattr(tenv, accessor)(name, 11) == want
