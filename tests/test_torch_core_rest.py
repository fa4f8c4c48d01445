"""The rest of the port's ``core`` on the CPU: ``fanout`` (``async_fanout``,
``row_batches``, ``prefetch_to_device``), ``interruptible`` and
``Resources.sync`` as a cancellation point, ``manager`` (pooling,
freezing, out-of-range ids, raising without a card), ``native`` (built
into ``raft_tpu_torch/_build/``, its host algorithms against the port's
plain results, its token and ``Resources.native``), as raft_tpu's
``tests/test_parity_extras.py`` and ``tests/test_native.py`` hold
raft_tpu's."""

import os
import threading

import numpy as np
import pytest
import torch

from raft_tpu_torch.core import (async_fanout, interruptible, manager, native,
                                 prefetch_to_device, resources, row_batches)
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.neighbors.refine import refine
from raft_tpu_torch.ops import matrix

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


@pytest.fixture
def native_core():
    """The native core, built on first use (skips where no C++ compiler is)."""
    if not native.available():
        pytest.skip("no C++ compiler: the native core is unavailable")
    return native


def test_async_fanout_equals_sequential_calls():
    rng = np.random.default_rng(0)
    x = rng.random((500, 8), dtype=np.float32)
    qs = [rng.random((20, 8), dtype=np.float32) for _ in range(5)]
    outs = async_fanout(lambda q: brute_force.knn(x, q, 4, res=CPU), [(q,) for q in qs])
    for q, (v, i) in zip(qs, outs):
        want = brute_force.knn(x, q, 4, res=CPU)
        assert torch.equal(v, want[0]) and torch.equal(i, want[1])
    assert async_fanout(lambda a, b: {"s": [a + b]}, [(1, 2), (3, 4)]) == [{"s": [3]}, {"s": [7]}]


def test_row_batches():
    x = np.arange(23)
    parts = list(row_batches(x, 5))
    assert [len(p) for p in parts] == [5, 5, 5, 5, 3]
    np.testing.assert_array_equal(np.concatenate(parts), x)
    assert [p.shape[0] for p in row_batches(torch.zeros(10, 2), 10)] == [10]


@pytest.mark.parametrize("lookahead", [0, 1, 3])
def test_prefetch_to_device_on_the_cpu(lookahead):
    rng = np.random.default_rng(1)
    chunks = [rng.random((7, 3), dtype=np.float32) for _ in range(5)]
    got = list(prefetch_to_device(iter(chunks), lookahead, device="cpu"))
    assert len(got) == 5
    for g, c in zip(got, chunks):
        assert isinstance(g, torch.Tensor) and np.array_equal(g.numpy(), c)
    t = [torch.ones(2)]
    assert list(prefetch_to_device(t, device="cpu"))[0] is t[0]


def test_prefetch_to_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = resources._default
    resources.set_default_resources(Resources())
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(prefetch_to_device([np.zeros(3)]))
    finally:
        resources.set_default_resources(before)


def _cancel_from_another_thread(tid):
    t = threading.Thread(target=interruptible.cancel, args=(tid,))
    t.start()
    t.join()


def test_sync_is_a_cancellation_point():
    res = Resources(device="cpu")
    res.sync()                 # a no-op when not cancelled
    res.sync(torch.ones(3))
    _cancel_from_another_thread(threading.get_ident())
    with pytest.raises(InterruptedError):
        res.sync()
    res.sync()                 # the failed check cleared the flag


def test_a_thread_looping_on_sync_is_cancelled_from_another():
    res = Resources(device="cpu")
    started, outcome = threading.Event(), []

    def worker():
        started.set()
        try:
            for _ in range(10_000_000):
                res.sync()
            outcome.append("never cancelled")
        except InterruptedError:
            outcome.append("cancelled")

    t = threading.Thread(target=worker)
    t.start()
    started.wait()
    interruptible.cancel(t.ident)
    t.join(timeout=60)
    assert outcome == ["cancelled"]


def test_tokens_are_per_thread_and_dead_threads_are_pruned():
    seen = {}

    def remember():
        seen["tid"] = threading.get_ident()
        interruptible.get_token()

    t = threading.Thread(target=remember)
    t.start()
    t.join()
    assert seen["tid"] in interruptible._tokens
    interruptible.cancel(threading.get_ident())   # prunes the dead thread's entry
    assert seen["tid"] not in interruptible._tokens
    other = interruptible.get_token(12345678)
    assert other is not interruptible.get_token() and not other.cancelled
    with pytest.raises(InterruptedError):
        interruptible.check()
    interruptible.check()
    interruptible._tokens.pop(12345678, None)


def test_own_token_is_native_where_the_core_is_available():
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("tok", interruptible.get_token()))
    t.start()
    t.join()
    want = native.InterruptibleToken if native.available() else interruptible._PyToken
    assert isinstance(out["tok"], want)


@pytest.fixture
def fresh_manager():
    manager.reset()
    yield manager
    manager.reset()


def test_manager_raises_without_a_card(fresh_manager, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        manager.get_device_resources(0)
    manager.set_workspace_limit(1 << 20)   # a failed call froze nothing


def test_manager_pools_and_freezes(fresh_manager, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    manager.set_workspace_limit(1 << 20)
    manager.set_seed(7)
    with pytest.raises(ValueError, match="out of range"):
        manager.get_device_resources(2)
    with pytest.raises(ValueError, match="out of range"):
        manager.get_device_resources(-1)
    manager.set_seed(9)                    # an invalid id froze nothing
    r0 = manager.get_device_resources(0)
    assert r0.workspace_limit_bytes == 1 << 20 and r0._device == torch.device("cuda:0")
    assert manager.get_device_resources(0) is r0
    r1 = manager.get_device_resources(1)
    assert r1 is not r0 and r1._device == torch.device("cuda:1") and r1._seed == 10
    for setter in (manager.set_workspace_limit, manager.set_seed):
        with pytest.raises(RuntimeError, match="frozen"):
            setter(2)


def test_native_builds_into_the_port_tree(monkeypatch):
    if not native.available():
        monkeypatch.setattr(native, "_cxx", lambda: None)
        with pytest.raises(RuntimeError, match="unavailable"):
            native.build()
        return
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libraft_tpu_core_")
    assert native.build() == path          # up to date: not rebuilt
    assert not list(native.BUILD_DIR.glob("native_*.o"))
    monkeypatch.setattr(native, "_cxx", lambda: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()


def test_native_host_algorithms_match_the_plain_port(native_core):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((600, 16)).astype(np.float32)
    q = rng.standard_normal((30, 16)).astype(np.float32)
    cand = np.argsort(rng.random((30, 600)), axis=1)[:, :40].astype(np.int32)
    for metric in ("sqeuclidean", "inner_product"):
        d, i = native.refine_host(x, q, cand, 8, metric=metric)
        td, ti = refine(x, q, cand, 8, metric=metric, res=CPU)
        np.testing.assert_allclose(d, td.numpy(), rtol=1e-4, atol=1e-4)
        assert (i == ti.numpy()).mean() >= 0.99
    scores = np.round(rng.standard_normal((20, 300)) * 4).astype(np.float32)
    v, i = native.select_k_host(scores, 12)
    tv, ti = matrix.select_k(torch.from_numpy(scores), 12)
    np.testing.assert_array_equal(v, tv.numpy())
    np.testing.assert_array_equal(np.take_along_axis(scores, i, 1), tv.numpy())
    d, i = native.knn_host(x, q, 5)
    bd, bi = brute_force.knn(x, q, 5, res=CPU)
    np.testing.assert_array_equal(i, bi.numpy())
    np.testing.assert_allclose(d, bd.numpy(), rtol=1e-4, atol=1e-4)


def test_native_token_and_resources(native_core, tmp_path):
    tok = native.InterruptibleToken()
    assert not tok.cancelled
    tok.cancel()
    assert tok.cancelled
    with pytest.raises(InterruptedError):
        tok.check()
    tok.check()
    res = Resources(device="cpu", workspace_limit_bytes=1 << 12)
    nres = res.native
    assert res.native is nres
    p = nres.workspace_alloc(1000)
    assert nres.workspace_used >= 1000
    nres.workspace_free(p)
    with pytest.raises(MemoryError):
        nres.workspace_alloc(1 << 13)
    arr = np.arange(12, dtype=np.int64).reshape(3, 4)
    native.npy_write(str(tmp_path / "a.npy"), arr)
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), arr)
    np.testing.assert_array_equal(native.npy_read(str(tmp_path / "a.npy")), arr)


def test_resources_native_is_none_without_the_core(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    assert Resources(device="cpu").native is None
