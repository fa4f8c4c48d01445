"""The port's comms facade against raft_tpu's: the same seeded inputs
through every verb on the port's mesh of eight CPU shards and raft_tpu's
eight virtual devices give equal outputs (f32 sums within 1e-6 relative),
``quantized_psum`` rounds bf16 and int8 wires as raft_tpu's does, the
self-tests pass on 1-D and 2-D meshes, and two gloo processes of two
shards each give what one process of four gives: the moving verbs and
integer sums bitwise, a float sum bitwise ``(x0 + x1) + (x2 + x3)`` (each
process sums its own shards, then the process group sums the partials)
and within 1e-6 of the one process's rank-order sum, relative to the sum
of the terms' magnitudes."""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu import comms as jc
from raft_tpu.core.compat import shard_map
from raft_tpu_torch import comms as tc

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

S = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jcomms():
    assert len(jax.devices()) == S
    return jc.local_comms(S)


@pytest.fixture(scope="module")
def tcomms():
    return tc.local_comms(devices=["cpu"] * S)


def _raft(jcomms, body, x):
    """raft_tpu's verb over shards x[r] (stacked [S, ...]): [S, ...] out."""
    f = shard_map(lambda v: body(v[0])[None], mesh=jcomms.mesh,
                  in_specs=(P("data"),), out_specs=P("data"), check_vma=False)
    return np.asarray(f(jnp.asarray(x)))


def _port(verb_out):
    return np.stack([t.numpy() for t in verb_out])


def _inputs(seed, shape=(6, 5)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S,) + shape) * rng.uniform(0.1, 100, shape)).astype(np.float32)


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
def test_allreduce_matches_raft(jcomms, tcomms, op):
    x = _inputs(1)
    if op == "prod":
        x = np.sign(x) * np.exp(np.random.default_rng(2).uniform(-0.5, 0.5, x.shape)).astype(
            np.float32)
        x[3, 0, 0] = 0.0
    want = _raft(jcomms, lambda v: jcomms.allreduce(v, op), x)
    got = _port(tcomms.allreduce(list(torch.from_numpy(x)), op))
    if op == "prod":   # raft_tpu forms the product from logs: within rounding
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("root", [0, 5])
def test_bcast_and_reduce_match_raft(jcomms, tcomms, root):
    x = _inputs(3)
    xs = list(torch.from_numpy(x))
    np.testing.assert_array_equal(_port(tcomms.bcast(xs, root)),
                                  _raft(jcomms, lambda v: jcomms.bcast(v, root), x))
    np.testing.assert_allclose(_port(tcomms.reduce(xs, root)),
                               _raft(jcomms, lambda v: jcomms.reduce(v, root), x), rtol=1e-6)


@pytest.mark.parametrize("axis, tiled", [(0, True), (1, True), (0, False), (1, False)])
def test_allgather_matches_raft(jcomms, tcomms, axis, tiled):
    x = _inputs(4)
    want = _raft(jcomms, lambda v: jcomms.allgather(v, axis=axis, tiled=tiled), x)
    got = _port(tcomms.allgather(list(torch.from_numpy(x)), axis=axis, tiled=tiled))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _port(tcomms.gather(list(torch.from_numpy(x)), 2, axis=axis)) if tiled else got, want)


@pytest.mark.parametrize("tiled", [True, False])
def test_reducescatter_matches_raft(jcomms, tcomms, tiled):
    x = _inputs(5, (S * 2, 3) if tiled else (S, 3))
    want = _raft(jcomms, lambda v: jcomms.reducescatter(v, tiled=tiled), x)
    got = _port(tcomms.reducescatter(list(torch.from_numpy(x)), tiled=tiled))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("offset", [1, 3, -1])
def test_device_sendrecv_matches_raft(jcomms, tcomms, offset):
    x = _inputs(6)
    want = _raft(jcomms, lambda v: jcomms.device_sendrecv(v, offset), x)
    np.testing.assert_array_equal(
        _port(tcomms.device_sendrecv(list(torch.from_numpy(x)), offset)), want)


@pytest.mark.parametrize("split_axis, concat_axis", [(0, 0), (0, 1), (1, 0)])
def test_alltoall_matches_raft(jcomms, tcomms, split_axis, concat_axis):
    x = _inputs(7, (S * 2, S))
    want = _raft(jcomms, lambda v: jcomms.alltoall(v, split_axis=split_axis,
                                                    concat_axis=concat_axis), x)
    got = _port(tcomms.alltoall(list(torch.from_numpy(x)), split_axis=split_axis,
                                concat_axis=concat_axis))
    np.testing.assert_array_equal(got, want)


def test_allgatherv_and_barrier_match_raft(jcomms, tcomms):
    x = _inputs(8, (4,))
    lens = np.arange(1, S + 1, dtype=np.int32)[:, None]
    f = shard_map(lambda v, n: tuple(o[None] for o in jcomms.allgatherv(v[0], n[0])),
                  mesh=jcomms.mesh, in_specs=(P("data"), P("data")),
                  out_specs=(P("data"), P("data")), check_vma=False)
    g_want, l_want = (np.asarray(a) for a in f(jnp.asarray(x), jnp.asarray(lens)))
    got = tcomms.allgatherv(list(torch.from_numpy(x)), list(torch.from_numpy(lens)))
    np.testing.assert_array_equal(np.stack([g.numpy() for g, _ in got]), g_want)
    np.testing.assert_array_equal(np.stack([n.numpy() for _, n in got]), l_want)
    bar = _raft(jcomms, lambda v: jcomms.barrier_value() + 0 * v[0], x)
    np.testing.assert_array_equal(_port(tcomms.barrier_value()), bar)


@pytest.mark.parametrize("reduce_dtype", ["float32", "bfloat16", "int8"])
def test_quantized_psum_matches_raft(jcomms, tcomms, reduce_dtype):
    x = _inputs(9, (5, 7))
    x[:, :, 2] = 0.0          # a zero column takes scale 1
    want = _raft(jcomms, lambda v: jc.quantized_psum(v, "data", reduce_dtype), x)
    got = _port(tc.quantized_psum(tcomms, list(torch.from_numpy(x)), reduce_dtype))
    np.testing.assert_array_equal(got, want)
    exact = x.astype(np.float64).sum(0)
    err = np.abs(got[0] - exact).max() / np.abs(exact).max()
    assert err < {"float32": 1e-6, "bfloat16": 1e-2, "int8": 5e-2}[reduce_dtype]


@pytest.mark.parametrize("value, want", [(None, "float32"), ("f32", "float32"),
                                         ("BF16", "bfloat16"), (" int8 ", "int8"),
                                         ("fp8", ValueError)])
def test_reduce_dtype_from_env_matches_raft(value, want, monkeypatch):
    if value is None:
        monkeypatch.delenv("RAFT_TPU_BUILD_REDUCE_DTYPE", raising=False)
    else:
        monkeypatch.setenv("RAFT_TPU_BUILD_REDUCE_DTYPE", value)
    if want is ValueError:
        with pytest.raises(ValueError, match="not understood"):
            tc.reduce_dtype_from_env()
        with pytest.raises(ValueError):
            jc.reduce_dtype_from_env()
    else:
        assert tc.reduce_dtype_from_env() == jc.reduce_dtype_from_env() == want


def _selftests(comms, split_axis=None):
    names = [n for n in tc.__all__ if n.startswith("perform_test_comms")]
    out = {n: getattr(tc, n)(comms) for n in names}
    if split_axis is not None:
        out["comm_split"] = tc.perform_test_comm_split(comms, split_axis)
    return out


def test_selftests_pass_on_one_and_two_axis_meshes(tcomms):
    assert all(_selftests(tcomms).values())
    mesh = tc.make_mesh(devices=["cpu"] * S, axis_names=("data", "model"), shape=(4, 2))
    c = tc.Comms(mesh, "data")
    assert c.get_size() == 4 and c.ranks() == [0, 0, 1, 1, 2, 2, 3, 3]
    res = _selftests(c, "model")
    assert all(res.values()), res
    assert all(_selftests(c.comm_split("model"), "data").values())


def test_two_axis_verbs_reduce_within_their_axis():
    mesh = tc.make_mesh(devices=["cpu"] * S, axis_names=("data", "model"), shape=(4, 2))
    xs = [torch.full((2,), float(p)) for p in range(S)]
    over_data = tc.Comms(mesh, "data").allreduce(xs)
    over_model = tc.Comms(mesh, "model").allreduce(xs)
    # positions (i, j) = 2 i + j
    assert [float(t[0]) for t in over_data] == [12.0, 16.0] * 4
    assert [float(t[0]) for t in over_model] == [1.0, 1.0, 5.0, 5.0, 9.0, 9.0, 13.0, 13.0]


def test_mesh_and_run_contracts(tcomms):
    with pytest.raises(ValueError, match="holds"):
        tc.make_mesh(devices=["cpu"] * 4, shape=(3,))
    with pytest.raises(ValueError, match="not in mesh"):
        tc.Comms(tc.make_mesh(devices=["cpu"] * 2), "model")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
            tc.make_mesh()
    x = torch.arange(S * 3, dtype=torch.float32).reshape(S * 3, 1)
    parts = tcomms.shard(x)
    assert [p.shape[0] for p in parts] == [3] * S
    outs = tcomms.run(lambda rank, part, rep: (rank, float(part[0, 0] + rep)), parts,
                      replicated=(torch.tensor(0.5),))
    assert outs == [(r, 3.0 * r + 0.5) for r in range(S)]
    with pytest.raises(ValueError, match="divide"):
        tcomms.shard(torch.zeros(S + 1))
    tcomms.sync_stream()


def test_initialize_refuses_incomplete_launcher_contract_and_missing_cuda(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_COORDINATOR", "localhost:1")
    monkeypatch.delenv("RAFT_TPU_NUM_PROCS", raising=False)
    monkeypatch.delenv("RAFT_TPU_PROC_ID", raising=False)
    with pytest.raises(RuntimeError, match="launcher contract"):
        tc.initialize()
    assert not tc.is_initialized() and tc.process_count() == 1 and tc.process_index() == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tc.initialize("localhost:1", 2, 0, device="cuda")
        assert not tc.is_initialized()


WORKER = r"""
import os, sys, torch
proc_id, nprocs, port, via_env = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from raft_tpu_torch import comms as rc
if via_env == "1":
    os.environ.update(RAFT_TPU_COORDINATOR=f"localhost:{port}", RAFT_TPU_NUM_PROCS=str(nprocs),
                      RAFT_TPU_PROC_ID=str(proc_id))
    cl = rc.CommsCluster(axis_names=("data", "model"), mesh_shape=(nprocs, 2), device="cpu",
                         local_devices=["cpu", "cpu"])
else:
    cl = rc.CommsCluster(coordinator_address=f"localhost:{port}", num_processes=nprocs,
                         process_id=proc_id, axis_names=("data", "model"),
                         mesh_shape=(nprocs, 2), device="cpu", local_devices=["cpu", "cpu"])
cl.init()
assert rc.is_initialized() and rc.process_count() == nprocs and rc.process_index() == proc_id
h = rc.local_handle(cl.session_id)
assert h is not None and h.comms is cl.comms and h.mesh is cl.mesh
assert rc.get_raft_comm_state(cl.session_id)["nranks"] == nprocs
c = cl.comms
res = {n: getattr(rc, n)(c) for n in rc.__all__ if n.startswith("perform_test_comms")}
res["comm_split"] = rc.perform_test_comm_split(c, "model")
# 2 processes x 2 shards against one process of 4: each process sums its
# own shards in rank order, then the process group sums the partials
flat = rc.Comms(rc.global_mesh(("data",), None, ["cpu", "cpu"]), "data")
g = torch.Generator().manual_seed(0)
xs = [torch.randn(3, 5, generator=g) * 1e3 for _ in range(2 * nprocs)]
mine = [xs[p] for p in flat.mesh.local_positions]
one = rc.Comms(rc.make_mesh(devices=["cpu"] * (2 * nprocs)), "data")
got = flat.allreduce(mine)
res["allreduce_equal"] = all(torch.equal(t, (xs[0] + xs[1]) + (xs[2] + xs[3])) for t in got)
res["allreduce_close"] = bool(
    ((got[0] - one.allreduce(xs)[0]).abs() <= 1e-6 * sum(x.abs() for x in xs)).all())
res["allreduce_max_equal"] = torch.equal(flat.allreduce(mine, "max")[1],
                                         one.allreduce(xs, "max")[0])
ints = [torch.randint(-1000, 1000, (4, 3), generator=g) for _ in range(2 * nprocs)]
res["allreduce_int_equal"] = torch.equal(
    flat.allreduce([ints[p] for p in flat.mesh.local_positions])[0], one.allreduce(ints)[0])
res["allgather_equal"] = torch.equal(flat.allgather(mine, axis=1)[1], one.allgather(xs, axis=1)[0])
res["quantized_equal"] = torch.equal(rc.quantized_psum(flat, mine, "int8")[0],
                                     rc.quantized_psum(one, xs, "int8")[0])
failed = [k for k, v in res.items() if not v]
assert not failed, failed
cl.destroy()
assert rc.local_handle(cl.session_id) is None
rc.shutdown()
print(f"WORKER_OK {proc_id}", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("via_env", ["0", "1"])
def test_two_gloo_processes_match_one_process(tmp_path, via_env):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(WORKER))
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2", port, via_env],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(tmp_path)) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in out, err[-2000:]


@pytest.mark.cuda
def test_selftests_on_four_shards_of_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = tc.local_comms(devices=["cuda:0"] * 4)
    assert all(_selftests(c).values())
