"""Package-level contracts of the PyTorch port ``raft_tpu_torch``: it
imports neither JAX nor raft_tpu, runs on CUDA unless asked for the CPU,
and each kernel matches its plain version on the card (``cuda``-marked
tests, skipped without a card)."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.kernels import cagra_traverse, fused_knn, ivf_scan, select_k
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq, refine

from _torch_parity import hop_inputs, paged_lists

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "raft_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                                REPO / "kernel_ab.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "raft_tpu")


def test_port_imports_no_jax_and_no_raft_tpu():
    assert len(PORT_FILES) > 15  # the walk found the package
    bad = [(p.relative_to(REPO).as_posix(), m) for p in PORT_FILES
           for m in _imported_modules(p) if _forbidden(m)]
    assert bad == []


def test_import_check_covers_the_serving_layer_and_its_observability():
    """The walk of ``test_port_imports_no_jax_and_no_raft_tpu`` reaches every
    module of ``serve/`` and ``obs/``."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for mod in ("batcher", "compactor", "effort", "metrics", "mutation", "overload", "ragged",
                "registry", "service", "__init__"):
        assert f"raft_tpu_torch/serve/{mod}.py" in names
    for mod in ("explain", "flight", "health", "incidents", "perf", "profiler", "quality", "slo",
                "autotune", "gateway"):
        assert f"raft_tpu_torch/obs/{mod}.py" in names
    for mod in ("bench/frontier", "bench/plot", "stats/metrics", "stats/summary"):
        assert f"raft_tpu_torch/{mod}.py" in names


def test_forbidden_import_check_is_not_vacuous():
    assert _forbidden("jax.numpy") and _forbidden("raft_tpu.kernels")
    assert not _forbidden("raft_tpu_torch.kernels") and not _forbidden("torch")


def test_resources_default_to_cuda():
    assert Resources()._device == torch.device("cuda")
    assert Resources(device="cpu").device == torch.device("cpu")


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        brute_force.knn(x, x[:4], 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_flat.build(ivf_flat.IndexParams(n_lists=4, kmeans_n_iters=2), x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kmeans_balanced.predict(x[:4], x)
    cpu = Resources(device="cpu")
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=4, kmeans_n_iters=2), x, res=cpu)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_flat.search(ivf_flat.SearchParams(n_probes=4), idx, x[:4], 3)
    _, i = ivf_flat.search(ivf_flat.SearchParams(n_probes=4), idx, x[:4], 3, res=cpu)
    assert (i[:, 0].numpy() == np.arange(4)).all()


def test_ivf_pq_and_refine_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((400, 16)).astype(np.float32)
    params = ivf_pq.IndexParams(n_lists=4, pq_dim=8, kmeans_n_iters=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_pq.build(params, x)
    cand = np.tile(np.arange(8, dtype=np.int32), (4, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        refine.refine(x, x[:4], cand, 3)
    cpu = Resources(device="cpu")
    idx = ivf_pq.build(params, x, res=cpu)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivf_pq.search(ivf_pq.SearchParams(n_probes=4), idx, x[:4], 3)
    _, i = ivf_pq.search(ivf_pq.SearchParams(n_probes=4), idx, x[:4], 8, res=cpu)
    _, i = refine.refine(x, x[:4], i, 1, res=cpu)
    assert (i[:, 0].numpy() == np.arange(4)).all()


def test_cpu_searches_serve_k_past_the_kernel_envelope():
    """CPU tensors take the plain versions at any k, so k = 550 (past the
    kernels' 512) searches on the CPU; exhaustive probes give the oracle's
    ids."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((600, 8)).astype(np.float32)
    q = rng.standard_normal((7, 8)).astype(np.float32)
    cpu = Resources(device="cpu")
    bv, bi = brute_force.knn(x, q, 550, res=cpu)
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=4, kmeans_n_iters=2), x, res=cpu)
    for strategy in ("query_major", "probe_major"):
        v, i = ivf_flat.search(ivf_flat.SearchParams(n_probes=4, strategy=strategy), idx, q,
                               550, res=cpu)
        assert torch.equal(i, bi)
        torch.testing.assert_close(v, bv, rtol=1e-5, atol=1e-4)
    pq = ivf_pq.build(ivf_pq.IndexParams(n_lists=4, pq_dim=4, kmeans_n_iters=2), x, res=cpu)
    _, i = ivf_pq.search(ivf_pq.SearchParams(n_probes=4), pq, q, 550, res=cpu)
    assert i.shape == (7, 550) and bool((i >= 0).all())


def test_kernel_build_needs_nvcc():
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc present: the build itself is exercised on the card")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_launch_counts_reset_and_read():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    kernels.count_launch("select_k")
    assert kernels.launch_counts()["select_k"] == 1
    # each storage leg of the scans, unfiltered and on each filter leg,
    # monolithic and paged, counts on its own
    from raft_tpu_torch.store import PagedLists

    words = torch.zeros((1, 1), dtype=torch.int32)
    for schedule, legs in (("probe_major", [(None, None), (words, None)]),
                           ("query_major", [(None, None), (words, None), (words, words)])):
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            lists = torch.zeros((1, 8, 1), dtype=dtype)
            for list_data in (lists, PagedLists(lists, torch.zeros(1, dtype=torch.int32), 1)):
                for list_filter, query_fid in legs:
                    name = ivf_scan.kernel_name(schedule, list_data, list_filter, query_fid)
                    assert name in kernels.KERNELS
                    kernels.count_launch(name)
        # raw 8-bit rows (IVF-Flat over uint8 / int8 datasets), unpaged and paged
        for dtype, suffix in ((torch.uint8, "_u8"), (torch.int8, "_s8")):
            lists = torch.zeros((1, 8, 1), dtype=dtype)
            for list_data in (lists, PagedLists(lists, torch.zeros(1, dtype=torch.int32), 1)):
                for list_filter, query_fid in legs:
                    name = ivf_scan.kernel_name(schedule, list_data, list_filter, query_fid,
                                                scan_scale=None)
                    assert suffix in name and name in kernels.KERNELS
                    kernels.count_launch(name)
    counts = kernels.launch_counts()
    assert len(kernels.KERNELS) == 58 and "cagra_fused_hop_paged" in kernels.KERNELS
    assert "csr_spmm" in kernels.KERNELS and kernels.trace_name("csr_spmm") == "csr_spmm_kernel"
    assert "cagra_traverse" in kernels.KERNELS and "cagra_traverse_paged" in kernels.KERNELS
    assert "fused_argmin" in kernels.KERNELS
    assert all(counts[n] == 1 for n in kernels.KERNELS if n.startswith("ivf_scan"))
    kernels.reset_launch_counts()
    assert sum(kernels.launch_counts().values()) == 0


# -- on the card ---------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("select_k_cost", (10000, 1104, 20)),
    ("ivf_scan_cost", (1376, 256, 1960, 128, 10)),
    ("fused_knn_cost", (256, 1000000, 128, 10)),
    ("cagra_traverse_cost", (512, 1, 64, 128, 64)),
])
def test_raft_cost_formulas_match_raft_tpu(name, args):
    from raft_tpu.ops import cost as jcost
    from raft_tpu_torch.ops import cost as tcost

    got, want = getattr(tcost, name)(*args), getattr(jcost, name)(*args)
    assert (got.flops, got.bytes_accessed) == (want.flops, want.bytes_accessed)


def test_work_bounds_count_what_the_inputs_need():
    from raft_tpu_torch.ops import cost

    # select_k reads ids only when they are passed
    assert cost.select_k_work(4, 100, 5).bytes_accessed == 4 * 100 * 4 + 4 * 5 * 8
    assert cost.select_k_work(4, 100, 5, with_ids=True).bytes_accessed == 4 * 100 * 8 + 4 * 5 * 8
    fk = cost.fused_knn_work(2, 1000, 16, 10)
    assert fk.flops == 2 * 1000 * 2 * 16
    ms, by = cost.bound_ms(fk)
    assert by == "bytes" and ms == pytest.approx(fk.bytes_accessed / cost.H100_BYTES_PER_S * 1e3)
    ms, by = cost.bound_ms(cost.fused_knn_work(10000, 1000000, 128, 10))
    assert by == "operations" and ms == pytest.approx(10000 * 1000000 * 256 / cost.H100_F32_FLOPS * 1e3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 129, 258, 512])
def test_select_k_kernel_matches_plain(cuda, k):
    g = torch.Generator().manual_seed(0)
    s = torch.round(torch.randn(300, 1000, generator=g) * 3)
    ids = torch.randint(-1, 40, (300, 1000), generator=g, dtype=torch.int32)
    for stable in (False, True):
        want = select_k.select_k_torch(s, k, stable=stable, input_indices=ids)
        got = select_k.select_k_kernel(s.to(cuda), k, stable=stable,
                                       input_indices=ids.to(cuda))
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 129, 258, 512])   # 512: fewer queries per block
def test_fused_knn_kernel_matches_plain(cuda, k):
    g = torch.Generator().manual_seed(1)
    x, q = torch.randn(20000, 64, generator=g), torch.randn(70, 64, generator=g)
    xx = (x * x).sum(1)
    want = fused_knn.fused_l2_topk_torch(q, x, xx, k)
    got = fused_knn.fused_l2_topk(q.to(cuda), x.to(cuda), xx.to(cuda), k)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-4)
    assert (got[1].cpu() == want[1]).float().mean() >= 0.999


def _select_rows(rows, n, g):
    """Rows for the select_k kernel: heavy ties (values rounded to a few
    levels), zeros of both signs, +inf pads at each row's tail and a few
    -inf."""
    s = torch.round(torch.randn(rows, n, generator=g) * 1.5)
    zero = s == 0
    s[zero] = torch.where(torch.rand(int(zero.sum()), generator=g) < 0.5,
                          torch.tensor(-0.0), torch.tensor(0.0))
    s[:, n - n // 7:] = float("inf")
    s[torch.rand(rows, n, generator=g) < 0.01] = float("-inf")
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 127, 128, 129, 256, 600, 2048])
def test_select_k_redesign_matches_plain_bitwise(cuda, k):
    """The redesigned select_k (#1: warp bitonic queue up to k = 256, block
    sort past it) against ``select_k_torch``, bitwise (values with their
    signs, ids): rows of n in {k, k + 1, 74, 128, 258, 1099, 4097, 8192}
    (those >= k), both directions, positional (ids given or not) and stable
    (ids with negatives); signed zeros tie up to k = 128 and rank -0.0
    first past it (positional), tie at every k (stable)."""
    g = torch.Generator().manual_seed(40 + k)
    for n in sorted({k, k + 1, 74, 128, 258, 1099, 4097, 8192}):
        if n < k:
            continue
        s = _select_rows(5, n, g)
        ids = torch.randint(-1, n // 3 + 2, (5, n), generator=g, dtype=torch.int32)
        for select_min in (True, False):
            for stable, ii in ((False, None), (False, ids), (True, ids), (True, None)):
                want = select_k.select_k_torch(s, k, select_min=select_min, stable=stable,
                                               input_indices=ii)
                kernels.reset_launch_counts()
                got = select_k.select_k_kernel(s.to(cuda), k, select_min=select_min,
                                               stable=stable,
                                               input_indices=None if ii is None else ii.to(cuda))
                torch.cuda.synchronize()
                assert kernels.launch_counts()["select_k"] == 1
                gv, gi = got[0].cpu(), got[1].cpu()
                assert torch.equal(gi, want[1]), (n, select_min, stable, ii is None)
                assert torch.equal(gv.view(torch.int32), want[0].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 128, 129, 512, 2048])
@pytest.mark.parametrize("mode", ["l2", "ip"])
def test_fused_knn_redesign_matches_plain_bitwise(cuda, k, mode):
    """fused_knn (#2, redesigned: candidate arrays and radix selection) against
    ``fused_l2_topk_torch``, bitwise: n_q and n not multiples of 64,
    duplicated dataset rows (score ties: the lower column wins), one part
    (n small) and several (the dataset cut over more blocks), both modes;
    d 40 stages four dimensions a copy, d 30 one."""
    g = torch.Generator().manual_seed(50 + k)
    for n, n_q, d in ((max(k, 300) + 37, 45, 40), (max(20 * k, 20000) + 11, 131, 30)):
        x = torch.round(torch.randn(n, d, generator=g) * 4) / 4
        x[n // 2: n // 2 + 50] = x[: 50]           # duplicates, later columns
        x[7 * n // 8: 7 * n // 8 + 10] = x[3]
        q = torch.randn(n_q, d, generator=g)
        q[: 5] = 0.0                                 # every ip score a zero: all tie
        xx = (x * x).sum(1)
        want = fused_knn.fused_l2_topk_torch(q.to(cuda), x.to(cuda), xx.to(cuda), k, mode=mode)
        kernels.reset_launch_counts()
        got = fused_knn.fused_l2_topk(q.to(cuda), x.to(cuda), xx.to(cuda), k, mode=mode)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["fused_knn"] == 1
        assert torch.equal(got[1], want[1]), (n, n_q)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


def _lists(cuda):
    g = torch.Generator().manual_seed(2)
    data = torch.randn(12, 300, 64, generator=g)
    ids = torch.arange(12 * 300, dtype=torch.int32).reshape(12, 300)
    ids[:, 250:] = -1
    y2 = torch.where(ids >= 0, (data * data).sum(-1), torch.zeros(()))
    return g, data, y2, ids


@pytest.mark.cuda
def test_probe_major_kernel_matches_plain(cuda):
    g, data, y2, ids = _lists(cuda)
    bl = torch.randint(0, 12, (20,), generator=g, dtype=torch.int32)
    qg = torch.randn(20, 100, 64, generator=g)
    q2g = (qg * qg).sum(-1)
    q2g[:, 90:] = float("inf")
    args = (bl, qg, q2g, data, y2, ids, 10)
    want = ivf_scan.ivf_scan_probe_major_torch(*args)
    got = ivf_scan.ivf_scan_probe_major(*(a.to(cuda) if torch.is_tensor(a) else a for a in args))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-4)
    assert (got[1].cpu() == want[1]).float().mean() >= 0.999


@pytest.mark.cuda
def test_query_major_kernel_matches_plain(cuda):
    g, data, y2, ids = _lists(cuda)
    probes = torch.randint(0, 12, (37, 5), generator=g, dtype=torch.int32)
    q = torch.randn(37, 64, generator=g)
    args = (probes, q, (q * q).sum(1), data, y2, ids, 10)
    want = ivf_scan.ivf_scan_query_major_torch(*args)
    got = ivf_scan.ivf_scan_query_major(*(a.to(cuda) if torch.is_tensor(a) else a for a in args))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-4)
    assert (got[1].cpu() == want[1]).float().mean() >= 0.999


@pytest.mark.cuda
# 40: past 48 KB of shared memory in all; 129 and 258: past the former
# envelope (258 > the lists' 250 real rows: +inf tails); 512: probe-major
# blocks then hold fewer queries (and the lists 600 slots, so that the
# lists hold real rows; kk past cap: test_kk_past_the_rows_scanned_matches_plain)
@pytest.mark.parametrize("kk", [10, 40, 129, 258, 512])
@pytest.mark.parametrize("schedule", ["probe_major", "query_major"])
@pytest.mark.parametrize("dtype,scan_dtype,d", [
    (torch.float32, "float32", 64),
    (torch.bfloat16, "float32", 64), (torch.bfloat16, "bfloat16", 64),
    (torch.float32, "bfloat16", 64), (torch.int8, "float32", 64),
    (torch.int8, "float32", 30),   # a row width that is not a multiple of 4
])
def test_storage_legs_match_plain_bitwise(cuda, schedule, dtype, scan_dtype, d, kk):
    """Each storage leg against its plain version on the card: the same
    summation order (fmaf in dimension order; exact bf16 products; exact
    int8 sums) makes values and ids bitwise equal."""
    g = torch.Generator().manual_seed(3)
    scale = 0.0173 if dtype == torch.int8 else 1.0
    cap = 300 if kk <= 300 else 600
    if dtype == torch.int8:
        data = torch.randint(-127, 128, (12, cap, d), generator=g, dtype=torch.int8)
        vals = data.float() * torch.tensor(scale, dtype=torch.float32)
    else:
        data = torch.randn(12, cap, d, generator=g).to(dtype)
        vals = data.float()
    ids = torch.arange(12 * cap, dtype=torch.int32).reshape(12, cap)
    ids[:, 250:] = -1
    y2 = torch.where(ids >= 0, (vals * vals).sum(-1), torch.zeros(()))
    kw = dict(scan_dtype=scan_dtype, scan_scale=scale)
    if schedule == "probe_major":
        qg = torch.randn(20, 100, d, generator=g)
        q2g = (qg * qg).sum(-1)
        q2g[:, 90:] = float("inf")
        args = (torch.randint(0, 12, (20,), generator=g, dtype=torch.int32), qg, q2g,
                data, y2, ids, kk)
        plain, kernel = ivf_scan.ivf_scan_probe_major_torch, ivf_scan.ivf_scan_probe_major
    else:
        q = torch.randn(37, d, generator=g)
        args = (torch.randint(0, 12, (37, 5), generator=g, dtype=torch.int32), q,
                (q * q).sum(1), data, y2, ids, kk)
        plain, kernel = ivf_scan.ivf_scan_query_major_torch, ivf_scan.ivf_scan_query_major
    on_card = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
    want = plain(*on_card, **kw)
    kernels.reset_launch_counts()
    got = kernel(*on_card, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[ivf_scan.kernel_name(schedule, data)] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [10, 40, 129])
@pytest.mark.parametrize("paged,filtered", [(False, False), (True, False), (False, True),
                                            (True, True)])
@pytest.mark.parametrize("dtype,scan_dtype,d", [
    (torch.float32, "float32", 100), (torch.float32, "bfloat16", 97),
    (torch.bfloat16, "float32", 100), (torch.bfloat16, "bfloat16", 97),
    (torch.uint8, "float32", 97), (torch.int8, "float32", 100),
])
def test_probe_major_float_legs_at_tile_edges_bitwise(cuda, dtype, scan_dtype, d, paged,
                                                      filtered, kk):
    """The float legs' 64 x 128 tile at its edges, bitwise the plain scan:
    a partial last chunk of 32 dimensions (100), rows whose width in bytes
    is no multiple of 16 (f32 at 97, bf16 at 97 and 100, 8-bit rows), G =
    70 (a second block of 6 queries), cap = 200 (a partial second tile),
    8-row pages, a filter, and kk in each fold class."""
    g = torch.Generator().manual_seed(d + kk)
    n_lists, cap = 6, 200
    if dtype in (torch.uint8, torch.int8):
        lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
        data = torch.randint(lo, hi, (n_lists, cap, d), generator=g).to(dtype)
    else:
        data = torch.randn(n_lists, cap, d, generator=g).to(dtype)
    ids = torch.arange(n_lists * cap, dtype=torch.int32).reshape(n_lists, cap)
    ids[1, 150:] = -1
    ids[4, 60:] = -1
    vals = data.float()
    y2 = torch.where(ids >= 0, (vals * vals).sum(-1), torch.zeros(()))
    qg = torch.randn(5, 70, d, generator=g) * (20.0 if dtype == torch.uint8 else 1.0)
    q2g = (qg * qg).sum(-1)
    q2g[:, 67:] = float("inf")
    bl = torch.randint(0, n_lists, (5,), generator=g, dtype=torch.int32)
    kw = dict(scan_dtype=scan_dtype,
              scan_scale=None if dtype in (torch.uint8, torch.int8) else 1.0)
    if filtered:
        bits = (torch.rand(n_lists, cap, generator=g) < 0.6) & (ids >= 0)
        bits = torch.nn.functional.pad(bits, (0, -cap % 32)).reshape(n_lists, -1, 32)
        kw["list_filter"] = (bits.long() << torch.arange(32)).sum(-1).to(torch.int32).to(cuda)
    rows = data.to(cuda)
    if paged:
        from raft_tpu_torch.store import PagedLists

        p = paged_lists(data, 8, d)
        rows = PagedLists(p.pool.to(cuda), p.page_slot.to(cuda), p.pages_per_list)
    args = [t.to(cuda) for t in (bl, qg, q2g)]
    lists = (y2.to(cuda), ids.to(cuda), kk)
    want = ivf_scan.ivf_scan_probe_major_torch(*args, data.to(cuda), *lists, **kw)
    kernels.reset_launch_counts()
    got = ivf_scan.ivf_scan_probe_major(*args, rows, *lists, **kw)
    torch.cuda.synchronize()
    name = ivf_scan.kernel_name("probe_major", rows, kw.get("list_filter"),
                                scan_scale=kw["scan_scale"])
    assert kernels.launch_counts()[name] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["probe_major", "query_major"])
def test_kk_past_the_rows_scanned_matches_plain(cuda, schedule):
    """kk 512 over lists of 300 slots (query-major: one probe): the kernel's
    +inf / -1 tails and the plain version's pads agree bitwise."""
    g = torch.Generator().manual_seed(5)
    data = torch.randn(6, 300, 64, generator=g)
    ids = torch.arange(6 * 300, dtype=torch.int32).reshape(6, 300)
    y2 = (data * data).sum(-1)
    if schedule == "probe_major":
        qg = torch.randn(4, 50, 64, generator=g)
        args = (torch.randint(0, 6, (4,), generator=g, dtype=torch.int32), qg,
                (qg * qg).sum(-1), data, y2, ids, 512)
        plain, kernel = ivf_scan.ivf_scan_probe_major_torch, ivf_scan.ivf_scan_probe_major
    else:
        q = torch.randn(20, 64, generator=g)
        args = (torch.randint(0, 6, (20, 1), generator=g, dtype=torch.int32), q,
                (q * q).sum(1), data, y2, ids, 512)
        plain, kernel = ivf_scan.ivf_scan_query_major_torch, ivf_scan.ivf_scan_query_major
    on_card = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
    want, got = plain(*on_card), kernel(*on_card)
    assert got[0].shape[-1] == 512 and torch.isinf(got[0][..., 300:]).all()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("decoded_dtype,lut_dtype", [
    ("bfloat16", "float32"), ("bfloat16", "bfloat16"), ("int8", "float32")])
def test_ivf_pq_search_and_refine_on_the_card(cuda, decoded_dtype, lut_dtype):
    """An IVF-PQ index built on the card searches through the storage leg's
    kernels (both schedules) to the same ids as on the CPU's plain
    versions, and refine agrees with its host path."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6000, 32)).astype(np.float32)
    q = rng.standard_normal((300, 32)).astype(np.float32)
    params = ivf_pq.IndexParams(n_lists=24, pq_dim=16, kmeans_n_iters=4,
                                decoded_dtype=decoded_dtype)
    idx = ivf_pq.build(params, x, res=Resources(device="cuda"))
    host = ivf_pq.Index(*(getattr(idx, f).cpu() if torch.is_tensor(getattr(idx, f))
                          else getattr(idx, f) for f in _PQ_FIELDS),
                        scan_scale=idx.scan_scale, headroom=idx.headroom)
    for strategy in ("query_major", "probe_major"):
        sp = ivf_pq.SearchParams(n_probes=6, lut_dtype=lut_dtype, strategy=strategy)
        kernels.reset_launch_counts()
        v, i = ivf_pq.search(sp, idx, q, 40)
        name = ivf_scan.kernel_name(strategy, idx.list_data)
        assert kernels.launch_counts()[name] > 0
        pv, pi = ivf_pq.search(sp, host, q, 40, res=Resources(device="cpu"))
        torch.testing.assert_close(v.cpu(), pv, rtol=1e-5, atol=1e-4)
        assert (i.cpu() == pi).float().mean() >= 0.999
    rv, ri = refine.refine(torch.from_numpy(x).to(cuda), q, i, 10)
    hv, hi = refine.refine(x, q, i.cpu().numpy(), 10, host=True)
    torch.testing.assert_close(rv.cpu(), hv, rtol=1e-5, atol=1e-4)
    assert (ri.cpu() == hi).float().mean() >= 0.999


@pytest.mark.cuda
def test_k_past_the_kernel_envelope_raises_on_the_card(cuda):
    """On the card every search goes to its kernels, which raise past
    k = 2048: no search falls back to a plain version there."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((24000, 32)).astype(np.float32)
    q = rng.standard_normal((300, 32)).astype(np.float32)
    res = Resources(device="cuda")
    flat = ivf_flat.build(ivf_flat.IndexParams(n_lists=8, kmeans_n_iters=2), x, res=res)
    pq = ivf_pq.build(ivf_pq.IndexParams(n_lists=8, pq_dim=16, kmeans_n_iters=2), x, res=res)
    assert flat.list_cap > 2049 and pq.list_cap > 2049
    kernels.reset_launch_counts()
    for strategy in ("query_major", "probe_major"):
        with pytest.raises(ValueError, match="kk<=2048"):
            ivf_flat.search(ivf_flat.SearchParams(n_probes=6, strategy=strategy), flat, q, 2049)
        with pytest.raises(ValueError, match="kk<=2048"):
            ivf_pq.search(ivf_pq.SearchParams(n_probes=6, strategy=strategy), pq, q, 2049)
    with pytest.raises(ValueError, match="k<=2048"):
        brute_force.knn(x, q, 2049, res=res)
    assert all(n == 0 for name, n in kernels.launch_counts().items() if name != "select_k")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [129, 258])
def test_searches_past_k_128_on_the_card_match_the_plain_versions(cuda, k):
    """k 129 and 258 (CAGRA's graph build: refine to 129 of IVF-PQ's 258)
    run on the card's kernels, both schedules, and agree with the CPU's
    plain versions."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6000, 32)).astype(np.float32)
    q = rng.standard_normal((300, 32)).astype(np.float32)
    res, cpu = Resources(device="cuda"), Resources(device="cpu")
    flat = ivf_flat.build(ivf_flat.IndexParams(n_lists=16, kmeans_n_iters=2), x, res=res)
    host = ivf_flat.Index(*(t.cpu() if torch.is_tensor(t) else t for t in (
        flat.metric, flat.centers, flat.list_data, flat.list_index, flat.list_sizes,
        flat.list_norms)))
    for strategy in ("query_major", "probe_major"):
        sp = ivf_flat.SearchParams(n_probes=6, strategy=strategy)
        kernels.reset_launch_counts()
        v, i = ivf_flat.search(sp, flat, q, k, res=res)
        assert kernels.launch_counts()[f"ivf_scan_{strategy}"] == 1
        pv, pi = ivf_flat.search(sp, host, q, k, res=cpu)
        torch.testing.assert_close(v.cpu(), pv, rtol=1e-5, atol=1e-4)
        assert (i.cpu() == pi).float().mean() >= 0.999
    bv, bi = brute_force.knn(x, q, k, res=res)
    pv, pi = brute_force.knn(x, q, k, res=cpu)
    torch.testing.assert_close(bv.cpu(), pv, rtol=1e-5, atol=1e-4)
    assert (bi.cpu() == pi).float().mean() >= 0.999


_PQ_FIELDS = ("metric", "codebook_kind", "pq_bits", "centers", "centers_rot", "rotation",
              "codebook", "list_codes", "list_index", "list_sizes", "list_data", "list_y2")


@pytest.mark.cuda
@pytest.mark.parametrize("metric,dtype,itopk,width", [
    ("sqeuclidean", torch.float32, 64, 1), ("inner_product", torch.float32, 64, 2),
    ("sqeuclidean", torch.bfloat16, 32, 2), ("sqeuclidean", torch.float32, 512, 1),
    ("inner_product", torch.float32, 64, 40),
])
def test_cagra_hop_kernel_matches_plain_bitwise(cuda, metric, dtype, itopk, width):
    """The hop kernel (the walk's kernel, one hop from given parents)
    against its plain version on the card: values, ids and explored flags
    bitwise equal (fmaf in dimension order on both sides), at a width past
    one warp of parents too."""
    x, *rest = hop_inputs(9, metric, n=4000, d=128, deg=64, tile=300, itopk=itopk, width=width)
    on_card = [x.to(dtype).to(cuda)] + [a.to(cuda) for a in rest]
    want = cagra_traverse.cagra_fused_hop_torch(*on_card, metric=metric)
    kernels.reset_launch_counts()
    got = cagra_traverse.cagra_fused_hop(*on_card, metric=metric)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["cagra_fused_hop"] == 1
    assert kernels.consume_kernel_path() == "cuda"
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got[1], on_card[5])


@pytest.mark.cuda
def test_cagra_search_on_the_card_matches_the_cpu(cuda):
    """A CAGRA search on the card (walk and select_k kernels, one walk
    launch per tile, no hop launch) agrees with the CPU's plain versions
    given one set of seed ids: ids on >= 99% of slots."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((100, 32)).astype(np.float32)
    cpu = Resources(device="cpu")
    idx = cagra.build(cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16,
                                        build_algo="brute_force"), x,
                      res=Resources(device="cuda"))
    assert idx.graph.shape == (3000, 16) and bool((idx.graph >= 0).all())
    host = cagra.from_graph(idx.metric, x, idx.graph.cpu(), idx.entry_centers.cpu(),
                            idx.entry_ids.cpu(), res=cpu)
    sp = cagra.SearchParams(itopk_size=32, max_queries=40)
    seeds = cagra.make_seed_ids(sp, host, torch.from_numpy(q), 10)
    kernels.reset_launch_counts()
    v, i = cagra.search(sp, idx, q, 10, seed_ids=seeds)
    assert kernels.consume_kernel_path() == "cuda"
    _, max_iter, tile = cagra.search_plan(sp, idx, 100, 10)
    counts = kernels.launch_counts()
    assert tile == 40 and counts["cagra_traverse"] == 3 and counts["cagra_fused_hop"] == 0
    pv, pi = cagra.search(sp, host, q, 10, seed_ids=seeds, res=cpu)
    assert (i.cpu() == pi).float().mean() >= 0.99
    torch.testing.assert_close(v.cpu(), pv, rtol=1e-5, atol=1e-4)


def _filter_leg_inputs(schedule, leg, dtype, d, kk, g):
    """Card-test inputs of a filter leg: 12 lists of 300 slots (250 real),
    pass bits at ~40 % with list 3 failing every slot; query-major gives
    the first query only list 3, so all its probes fail.  ``leg`` "filt":
    one plane [12, cap_w]; "fid": a table of 5 planes and each query's
    plane."""
    from raft_tpu_torch.core.bitset import Bitset

    cap, L = 300, 12
    scale = 0.0173 if dtype == torch.int8 else 1.0
    if dtype == torch.int8:
        data = torch.randint(-127, 128, (L, cap, d), generator=g, dtype=torch.int8)
        vals = data.float() * torch.tensor(scale, dtype=torch.float32)
    else:
        data = torch.randn(L, cap, d, generator=g).to(dtype)
        vals = data.float()
    ids = torch.arange(L * cap, dtype=torch.int32).reshape(L, cap)
    ids[:, 250:] = -1
    y2 = torch.where(ids >= 0, (vals * vals).sum(-1), torch.zeros(()))
    planes = 1 if leg == "filt" else 5
    masks = torch.rand(planes, L * cap, generator=g) < 0.4
    masks[:, ids[3].clamp(min=0).long()] = False
    table = torch.stack([ivf_scan.pack_list_filter(ids, Bitset.from_mask(m, device="cpu").words)
                         for m in masks])
    if schedule == "probe_major":
        qg = torch.randn(20, 100, d, generator=g)
        q2g = (qg * qg).sum(-1)
        q2g[:, 90:] = float("inf")
        bl = torch.randint(0, L, (20,), generator=g, dtype=torch.int32)
        bl[0] = 3
        args = (bl, qg, q2g, data, y2, ids, kk)
        kw = dict(list_filter=table[0])
    else:
        q = torch.randn(37, d, generator=g)
        probes = torch.randint(0, L, (37, 5), generator=g, dtype=torch.int32)
        probes[0] = 3
        args = (probes, q, (q * q).sum(1), data, y2, ids, kk)
        kw = (dict(list_filter=table[0]) if leg == "filt" else
              dict(list_filter=table, query_fid=torch.randint(0, planes, (37,), generator=g,
                                                              dtype=torch.int32)))
    return args, dict(scan_scale=scale, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [10, 129, 258])
@pytest.mark.parametrize("schedule,leg", [("probe_major", "filt"), ("query_major", "filt"),
                                          ("query_major", "fid")])
@pytest.mark.parametrize("dtype,scan_dtype,d", [
    (torch.float32, "float32", 64), (torch.bfloat16, "float32", 64),
    (torch.bfloat16, "bfloat16", 64), (torch.int8, "float32", 64), (torch.int8, "float32", 30),
])
def test_filter_legs_match_plain_bitwise(cuda, schedule, leg, dtype, scan_dtype, d, kk):
    """Each filter leg (one plane of words, or per-query planes) against its
    plain version on the card, bitwise; a list whose slots all fail and a
    query whose probes all fail come out +inf / -1; only the leg's own
    launch count moves."""
    g = torch.Generator().manual_seed(11)
    args, kw = _filter_leg_inputs(schedule, leg, dtype, d, kk, g)
    on_card = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
    kw_card = {n: a.to(cuda) if torch.is_tensor(a) else a for n, a in kw.items()}
    plain = getattr(ivf_scan, f"ivf_scan_{schedule}_torch")
    kernel = getattr(ivf_scan, f"ivf_scan_{schedule}")
    want = plain(*on_card, scan_dtype=scan_dtype, **kw_card)
    kernels.reset_launch_counts()
    got = kernel(*on_card, scan_dtype=scan_dtype, **kw_card)
    torch.cuda.synchronize()
    name = ivf_scan.kernel_name(schedule, args[3], kw["list_filter"], kw.get("query_fid"))
    assert name.endswith("_" + leg)
    assert {n: c for n, c in kernels.launch_counts().items() if c} == {name: 1}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isinf(got[0][0]).all() and (got[1][0] == -1).all()
    assert bool(torch.isfinite(got[0][1:, ..., 0]).any())


@pytest.mark.cuda
def test_filtered_searches_on_the_card_match_the_cpu(cuda):
    """ivf_flat, ivf_pq (bf16 and int8 caches), brute force and CAGRA with
    a Bitset, tombstones, and a RowFilter with and without its descriptor:
    the card's kernels agree with the CPU's plain versions, every IVF
    search launches its own filter leg, and no returned id fails its
    query's filter."""
    from raft_tpu_torch.core.bitset import Bitset, RowFilter
    from raft_tpu_torch.neighbors._common import resolve_pass_filter

    rng = np.random.default_rng(12)
    x = rng.standard_normal((6000, 32)).astype(np.float32)
    q = rng.standard_normal((300, 32)).astype(np.float32)
    res, cpu = Resources(device="cuda"), Resources(device="cpu")
    keep = rng.random(6000) < 0.3
    tomb = rng.random(6000) < 0.05
    table = rng.random((4, 6000)) < 0.5
    fid = rng.integers(0, 4, 300)
    words = torch.stack([Bitset.from_mask(t, device="cpu").words for t in table])

    def filters(dev):
        return {
            "bitset": (dict(sample_filter=Bitset.from_mask(keep, device=dev)), keep[None]),
            "tomb": (dict(deleted_mask=Bitset.from_mask(tomb, device=dev)), ~tomb[None]),
            "table": (dict(sample_filter=RowFilter.from_table(words, fid, 6000, device=dev)),
                      table[fid]),
            "rows": (dict(sample_filter=RowFilter.from_mask_rows(table[fid], device=dev)),
                     table[fid]),
        }

    flat = ivf_flat.build(ivf_flat.IndexParams(n_lists=16, kmeans_n_iters=2), x, res=res)
    host_flat = ivf_flat.Index(*(t.cpu() if torch.is_tensor(t) else t for t in (
        flat.metric, flat.centers, flat.list_data, flat.list_index, flat.list_sizes,
        flat.list_norms)))
    pq = ivf_pq.build(ivf_pq.IndexParams(n_lists=16, pq_dim=16, kmeans_n_iters=2), x, res=res)
    pq8 = ivf_pq.with_decoded_dtype(pq, "int8")
    searches = [("ivf_flat", flat, host_flat, ivf_flat.search, ivf_flat.SearchParams)]
    for idx in (pq, pq8):
        host = ivf_pq.Index(*(getattr(idx, f).cpu() if torch.is_tensor(getattr(idx, f))
                              else getattr(idx, f) for f in _PQ_FIELDS),
                            scan_scale=idx.scan_scale, headroom=idx.headroom)
        searches.append(("ivf_pq", idx, host, ivf_pq.search, ivf_pq.SearchParams))
    on_card, on_cpu = filters(cuda), filters("cpu")
    for tag, idx, host, search, params in searches:
        for fname, (kw, ok) in on_card.items():
            for strategy in ("query_major", "probe_major"):
                sp = params(n_probes=6, strategy=strategy)
                kernels.reset_launch_counts()
                v, i = search(sp, idx, q, 10, res=res, **kw)
                assert kernels.consume_kernel_path() == "cuda"
                leg = "filt" if fname in ("bitset", "tomb") else "fid"
                sched = strategy if leg == "filt" else "query_major"
                name = f"{ivf_scan.kernel_name(sched, idx.list_data)}_{leg}"
                assert kernels.launch_counts()[name] > 0, (tag, fname, strategy)
                pv, pi = search(sp, host, q, 10, res=cpu, **on_cpu[fname][0])
                torch.testing.assert_close(v.cpu(), pv, rtol=1e-5, atol=1e-4)
                assert (i.cpu() == pi).float().mean() >= 0.999
                ic = i.cpu().numpy()
                rows = np.arange(300)[:, None] % ok.shape[0]
                assert ok[rows, np.clip(ic, 0, None)][ic >= 0].all()
    for fname, (kw, ok) in on_card.items():
        v, i = brute_force.knn(x, q, 10, res=res, **kw)
        pv, pi = brute_force.knn(x, q, 10, res=cpu, **on_cpu[fname][0])
        torch.testing.assert_close(v.cpu(), pv, rtol=1e-5, atol=1e-4)
        assert (i.cpu() == pi).float().mean() >= 0.999
    cg = cagra.build(cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16,
                                       build_algo="brute_force"), x, res=res)
    host = cagra.from_graph(cg.metric, x, cg.graph.cpu(), cg.entry_centers.cpu(),
                            cg.entry_ids.cpu(), res=cpu)
    sp = cagra.SearchParams(itopk_size=32)
    for fname, (kw, ok) in on_card.items():
        pass_filter = resolve_pass_filter(on_cpu[fname][0].get("sample_filter"),
                                          on_cpu[fname][0].get("deleted_mask"))
        itopk, _, _ = cagra.search_plan(sp, host, 300, 10, cpu, pass_filter)
        seeds = cagra.make_seed_ids(sp, host, torch.from_numpy(q), 10, itopk=itopk)
        kernels.reset_launch_counts()
        v, i = cagra.search(sp, cg, q, 10, res=res, seed_ids=seeds, **kw)
        assert kernels.launch_counts()["cagra_fused_hop"] == 0
        pv, pi = cagra.search(sp, host, q, 10, res=cpu, seed_ids=seeds, **on_cpu[fname][0])
        assert (i.cpu() == pi).float().mean() >= 0.99
        ic = i.cpu().numpy()
        rows = np.arange(300)[:, None] % ok.shape[0]
        assert ok[rows, np.clip(ic, 0, None)][ic >= 0].all()


def _on(paged, dev):
    """A PagedLists / PagedRows with its pool and table moved to ``dev``."""
    from raft_tpu_torch.store import PagedLists

    if isinstance(paged, PagedLists):
        return PagedLists(paged.pool.to(dev), paged.page_slot.to(dev), paged.pages_per_list)
    return type(paged)(paged.pool.to(dev), paged.page_slot.to(dev), paged.n_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("page_rows", [8, 1024])
@pytest.mark.parametrize("kk", [10, 129])
@pytest.mark.parametrize("schedule,leg", [("probe_major", None), ("probe_major", "filt"),
                                          ("query_major", None), ("query_major", "filt"),
                                          ("query_major", "fid")])
@pytest.mark.parametrize("dtype,scan_dtype,d", [
    (torch.float32, "float32", 64), (torch.bfloat16, "float32", 64),
    (torch.bfloat16, "bfloat16", 64), (torch.int8, "float32", 64), (torch.int8, "float32", 30),
])
def test_paged_scan_legs_match_plain_and_unpaged_bitwise(cuda, schedule, leg, dtype, scan_dtype,
                                                         d, kk, page_rows):
    """Kernel #4 (and query-major's paged read) on lists placed page by page
    in a scattered pool: bitwise equal to its plain version, to the unpaged
    kernel on the same rows, and only the paged leg's count moves.  Page
    rows 8 make every 64-row tile straddle pages; 1024 is the default."""
    from _torch_parity import paged_lists

    g = torch.Generator().manual_seed(21)
    args, kw = _filter_leg_inputs(schedule, leg or "filt", dtype, d, kk, g)
    if leg is None:
        kw.pop("list_filter")
    # repad the 300-slot lists to a page multiple, as paginate_index does
    cap2 = -(-300 // page_rows) * page_rows
    data, y2, ids = args[3:6]
    pad = cap2 - data.shape[1]
    data = torch.nn.functional.pad(data, (0, 0, 0, pad))
    y2 = torch.nn.functional.pad(y2, (0, pad))
    ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    if "list_filter" in kw:
        lf = kw["list_filter"]
        kw["list_filter"] = torch.nn.functional.pad(lf, (0, -(-cap2 // 32) - lf.shape[-1]))
    paged = paged_lists(data, page_rows, 4)
    plain = getattr(ivf_scan, f"ivf_scan_{schedule}_torch")
    kernel = getattr(ivf_scan, f"ivf_scan_{schedule}")
    card = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
    mono = card[:3] + [data.to(cuda), y2.to(cuda), ids.to(cuda), kk]
    pag = card[:3] + [_on(paged, cuda), y2.to(cuda), ids.to(cuda), kk]
    kw_card = {n: a.to(cuda) for n, a in kw.items() if torch.is_tensor(a)}
    kw_card["scan_scale"] = kw["scan_scale"]
    want = plain(*pag, scan_dtype=scan_dtype, **kw_card)
    unpaged = kernel(*mono, scan_dtype=scan_dtype, **kw_card)
    kernels.reset_launch_counts()
    got = kernel(*pag, scan_dtype=scan_dtype, **kw_card)
    torch.cuda.synchronize()
    name = ivf_scan.kernel_name(schedule, pag[3], kw_card.get("list_filter"),
                                kw_card.get("query_fid"))
    assert "_paged" in name and name in kernels.KERNELS
    assert {n: c for n, c in kernels.launch_counts().items() if c} == {name: 1}
    for a, b, c in zip(got, want, unpaged):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert bool(torch.isfinite(got[0]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("page_rows", [8, 1024])
@pytest.mark.parametrize("metric,dtype", [("sqeuclidean", torch.float32),
                                          ("inner_product", torch.float32),
                                          ("sqeuclidean", torch.bfloat16)])
def test_paged_hop_matches_plain_and_dense_bitwise(cuda, metric, dtype, page_rows):
    """#8's paged leg on rows in a scattered pool: bitwise equal to its
    plain version (``PagedRows.decode``) and to the dense leg, with its own
    launch count."""
    from _torch_parity import paged_rows

    x, *rest = hop_inputs(9, metric, n=4000, d=128, deg=64, tile=300, itopk=64, width=2)
    x = x.to(dtype)
    rest = [a.to(cuda) for a in rest]
    paged = _on(paged_rows(x, page_rows, 6), cuda)
    want = cagra_traverse.cagra_fused_hop_torch(paged, *rest, metric=metric)
    dense = cagra_traverse.cagra_fused_hop(x.to(cuda), *rest, metric=metric)
    kernels.reset_launch_counts()
    got = cagra_traverse.cagra_fused_hop(paged, *rest, metric=metric)
    torch.cuda.synchronize()
    assert {n: c for n, c in kernels.launch_counts().items() if c} == {"cagra_fused_hop_paged": 1}
    for a, b, c in zip(got, want, dense):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_paged_searches_on_the_card_match_monolithic(cuda):
    """All four indexes paginated on the card (a pinned pool; IVF-Flat also
    over budget, a query at a time): ids and distances bitwise equal to the
    monolithic searches, and each IVF search launches its paged legs."""
    import copy

    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.store import MemoryBudget, paginate_index

    rng = np.random.default_rng(13)
    x = rng.standard_normal((6000, 32)).astype(np.float32)
    q = rng.standard_normal((300, 32)).astype(np.float32)
    res = Resources(device="cuda")
    keep = Bitset.from_mask(rng.random(6000) < 0.3, device="cuda")

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    flat = ivf_flat.build(ivf_flat.IndexParams(n_lists=32), x, res=res)
    pq = ivf_pq.build(ivf_pq.IndexParams(n_lists=32, pq_dim=16), x, res=res)
    for mod, idx, sp_cls in ((ivf_flat, flat, ivf_flat.SearchParams),
                             (ivf_pq, pq, ivf_pq.SearchParams)):
        paged = copy.copy(idx)
        paginate_index(paged, page_rows=64, budget=None)
        for strategy in ("probe_major", "query_major"):
            sp = sp_cls(n_probes=8, strategy=strategy)
            for kw in ({}, {"sample_filter": keep}):
                kernels.reset_launch_counts()
                got = mod.search(sp, paged, q, 10, res=res, **kw)
                assert same(got, mod.search(sp, idx, q, 10, res=res, **kw))
                assert any(c and "_paged" in n for n, c in kernels.launch_counts().items())
    over = copy.copy(flat)
    ppl = -(-flat.list_cap // 64)
    n_pages = flat.n_lists * ppl
    t = paginate_index(over, page_rows=64,
                       budget=MemoryBudget(n_pages // 4 * 64 * 32 * 4 + 4 * n_pages))
    sp = ivf_flat.SearchParams(n_probes=4)
    for row in q[:40]:
        assert same(ivf_flat.search(sp, over, row[None], 10, res=res),
                    ivf_flat.search(sp, flat, row[None], 10, res=res))
    assert t.misses > 0 and t.evictions > 0
    bf = brute_force.build(x, res=res)
    pbf = copy.copy(bf)
    paginate_index(pbf, page_rows=64, budget=None)
    assert same(brute_force.search(pbf, q, 10, res=res), brute_force.search(bf, q, 10, res=res))
    cg = cagra.build(cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16,
                                       build_algo="brute_force"), x, res=res)
    pcg = copy.copy(cg)
    paginate_index(pcg, page_rows=64, budget=None)
    sp = cagra.SearchParams(itopk_size=32)
    kernels.reset_launch_counts()
    assert same(cagra.search(sp, pcg, q, 10, res=res), cagra.search(sp, cg, q, 10, res=res))
    assert kernels.launch_counts()["cagra_traverse_paged"] > 0
    assert same(cagra.search(sp, pcg, q, 10, res=res, sample_filter=keep),
                cagra.search(sp, cg, q, 10, res=res, sample_filter=keep))


# -- deep k, raw 8-bit rows, kernel #7 ---------------------------------------


def _deep_inputs(schedule, dtype, raw, kk, g, leg=None):
    """Scan inputs whose lists hold more (passing) real rows than ``kk``: 6
    lists of kk + 96 slots (2 kk + 96 on a filter leg, which passes ~70 %),
    the last 40 padding, d 32; ``raw``: 8-bit rows of raw values
    (``scan_scale`` None), else an int8 cache at scale 0.0173.  ``leg``:
    None, "filt" (one plane) or "fid" (query-major, 3 planes)."""
    from raft_tpu_torch.core.bitset import Bitset

    L, cap, d = 6, (2 * kk if leg else kk) + 96, 32
    scale = None if raw else (0.0173 if dtype == torch.int8 else 1.0)
    if dtype in (torch.int8, torch.uint8):
        lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
        data = torch.randint(lo, hi, (L, cap, d), generator=g).to(dtype)
        vals = data.float() * (1.0 if raw else torch.tensor(scale, dtype=torch.float32))
    else:
        data = torch.randn(L, cap, d, generator=g).to(dtype)
        vals = data.float()
    ids = torch.arange(L * cap, dtype=torch.int32).reshape(L, cap)
    ids[:, cap - 40:] = -1
    y2 = torch.where(ids >= 0, (vals * vals).sum(-1), torch.zeros(()))
    kw = {"scan_scale": scale}
    if leg is not None:
        planes = 3 if leg == "fid" else 1
        masks = torch.rand(planes, L * cap, generator=g) < 0.7
        table = torch.stack([ivf_scan.pack_list_filter(ids, Bitset.from_mask(m, device="cpu").words)
                             for m in masks])
    q_scale = 40.0 if dtype in (torch.int8, torch.uint8) and raw else 1.0
    if schedule == "probe_major":
        qg = torch.randn(8, 40, d, generator=g) * q_scale
        q2g = (qg * qg).sum(-1)
        q2g[:, 35:] = float("inf")
        args = (torch.randint(0, L, (8,), generator=g, dtype=torch.int32), qg, q2g,
                data, y2, ids, kk)
        if leg is not None:
            kw["list_filter"] = table[0]
    else:
        q = torch.randn(20, d, generator=g) * q_scale
        args = (torch.randint(0, L, (20, 3), generator=g, dtype=torch.int32), q,
                (q * q).sum(1), data, y2, ids, kk)
        if leg == "filt":
            kw["list_filter"] = table[0]
        elif leg == "fid":
            kw.update(list_filter=table,
                      query_fid=torch.randint(0, 3, (20,), generator=g, dtype=torch.int32))
    return args, kw


def _run_leg(cuda, schedule, args, kw, scan_dtype="highest", paged_rows=None):
    """(kernel output, plain output, the leg's launch name, counts) of one
    scan leg on the card; ``paged_rows``: read the lists through a page
    table of pages of that many rows (a scattered pool)."""
    from _torch_parity import paged_lists

    card = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
    if paged_rows is not None:
        card[3] = _on(paged_lists(args[3], paged_rows, 4), cuda)
    kw_card = {n: a.to(cuda) if torch.is_tensor(a) else a for n, a in kw.items()}
    plain = getattr(ivf_scan, f"ivf_scan_{schedule}_torch")
    kernel = getattr(ivf_scan, f"ivf_scan_{schedule}")
    want = plain(*card, scan_dtype=scan_dtype, **kw_card)
    kernels.reset_launch_counts()
    got = kernel(*card, scan_dtype=scan_dtype, **kw_card)
    torch.cuda.synchronize()
    name = ivf_scan.kernel_name(schedule, card[3], kw_card.get("list_filter"),
                                kw_card.get("query_fid"), kw["scan_scale"])
    return got, want, name, {n: c for n, c in kernels.launch_counts().items() if c}


def _pad_to_pages(args, kw, page_rows):
    """Scan inputs with the lists' capacity padded up to a multiple of
    ``page_rows`` (padding slots, id -1), as paginate_index pads them."""
    cap2 = -(-args[3].shape[1] // page_rows) * page_rows
    pad = cap2 - args[3].shape[1]
    args = (*args[:3], torch.nn.functional.pad(args[3], (0, 0, 0, pad)),
            torch.nn.functional.pad(args[4], (0, pad)),
            torch.nn.functional.pad(args[5], (0, pad), value=-1), *args[6:])
    if "list_filter" in kw:
        lf = kw["list_filter"]
        kw = dict(kw, list_filter=torch.nn.functional.pad(lf, (0, -(-cap2 // 32) - lf.shape[-1])))
    return args, kw


_DEEP_LEGS = [  # (dtype, raw, scan_dtype, paged page rows)
    (torch.float32, False, "highest", None), (torch.bfloat16, False, "float32", None),
    (torch.bfloat16, False, "bfloat16", None), (torch.int8, False, "float32", None),
    (torch.uint8, True, "highest", None), (torch.int8, True, "highest", None),
    (torch.float32, False, "highest", 64), (torch.int8, False, "float32", 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [513, 1024, 2048])
@pytest.mark.parametrize("schedule,leg", [("probe_major", None), ("probe_major", "filt"),
                                          ("query_major", None), ("query_major", "filt"),
                                          ("query_major", "fid")])
@pytest.mark.parametrize("dtype,raw,scan_dtype,paged", _DEEP_LEGS)
def test_deep_k_scan_legs_match_plain_bitwise(cuda, schedule, leg, dtype, raw, scan_dtype,
                                              paged, kk):
    """Every scan leg (#3 / #5 storage legs, #6 fid, #4 paged, the raw 8-bit
    rows) past the former kk = 512, up to 2048: bitwise its plain version
    on the card, only the leg's own count moving; query-major's 20 queries
    split their probes, so the merge runs at kk too."""
    g = torch.Generator().manual_seed(31)
    args, kw = _deep_inputs(schedule, dtype, raw, kk, g, leg)
    if paged is not None:   # the lists' capacity must be a page multiple: pad kk + 96 up
        args, kw = _pad_to_pages(args, kw, paged)
    got, want, name, counts = _run_leg(cuda, schedule, args, kw, scan_dtype, paged)
    assert counts == {name: 1} and got[0].shape[-1] == kk
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(torch.isfinite(got[0][..., kk - 1]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [129, 258, 349, 350, 1000])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("leg", [None, "filt"])
@pytest.mark.parametrize("dtype,raw,scan_dtype,paged", _DEEP_LEGS)
def test_deep_kk_probe_major_fold_matches_plain_bitwise(cuda, leg, dtype, raw, scan_dtype, paged,
                                                        metric, kk):
    """The probe-major fold past kk = 128 (candidate arrays, radix-select
    compaction, a final bitonic sort) on every storage leg, filtered and
    paged, at the CAGRA build's kk = 258 and around it: bitwise its plain
    version, values compared by their bits (a -0.0 score stays -0.0).  List
    0 holds fewer real rows than kk (+inf / -1 tails), list 1 repeats one
    row ten times (the slot decides the ties), list 2 holds zero rows (at
    the inner product their scores are -0.0, tied with +0.0)."""
    g = torch.Generator().manual_seed(37)
    args, kw = _deep_inputs("probe_major", dtype, raw, kk, g, leg)
    bl, qg, q2g, data, y2, ids, _ = args
    bl = bl.clone()
    bl[:3] = torch.tensor([0, 1, 2], dtype=torch.int32)
    data, ids = data.clone(), ids.clone()
    ids[0, kk // 3:] = -1
    data[1, 10:20] = data[1, 3]
    data[2, :30] = 0
    vals = data.float() * (1.0 if kw["scan_scale"] is None
                           else torch.tensor(kw["scan_scale"], dtype=torch.float32))
    y2 = torch.where(ids >= 0, (vals * vals).sum(-1), torch.zeros(()))
    args = (bl, qg, q2g, data, y2, ids, kk)
    kw["metric"] = metric
    if paged is not None:
        args, kw = _pad_to_pages(args, kw, paged)
    got, want, name, counts = _run_leg(cuda, "probe_major", args, kw, scan_dtype, paged)
    assert counts == {name: 1} and got[0].shape == (8, 40, kk)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert bool((got[1][0] == -1).any()) and bool(torch.isfinite(got[0][..., kk - 1]).any())
    if metric == "inner_product":   # list 2's zero rows scored -0.0
        zero = got[0][2] == 0
        assert bool((zero & torch.signbit(got[0][2])).any())


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [10, 129])
@pytest.mark.parametrize("schedule,leg", [("probe_major", None), ("probe_major", "filt"),
                                          ("query_major", None), ("query_major", "filt"),
                                          ("query_major", "fid")])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "cosine"])
def test_raw_8bit_legs_match_plain_bitwise(cuda, schedule, leg, dtype, kk, metric):
    """The _u8 / _s8 legs (IVF-Flat over 8-bit datasets): values converted
    to f32 where they are staged, then the f32 legs' fmaf chain: bitwise
    the plain version's ``sequential_dot`` over the upcast rows."""
    g = torch.Generator().manual_seed(33)
    args, kw = _deep_inputs(schedule, dtype, True, kk, g, leg)
    kw["metric"] = metric
    got, want, name, counts = _run_leg(cuda, schedule, args, kw)
    assert ("_u8" if dtype == torch.uint8 else "_s8") in name
    assert counts == {name: 1}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("page_rows", [8, 64])
@pytest.mark.parametrize("kk", [10, 129])
@pytest.mark.parametrize("schedule,leg", [("probe_major", None), ("probe_major", "filt"),
                                          ("query_major", None), ("query_major", "filt"),
                                          ("query_major", "fid")])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_raw_8bit_legs_refuse_bf16_compute_and_paged_legs_match_plain_and_unpaged(
        cuda, schedule, leg, dtype, kk, page_rows):
    """The raw 8-bit legs refuse bf16 compute (raft_tpu scans such lists at
    "highest"); read through a page table (the _u8_paged / _s8_paged legs)
    they are bitwise their plain version and the unpaged kernel on the same
    rows, and only the paged leg's count moves.  Page rows 8 make every
    64-row tile straddle pages."""
    from _torch_parity import paged_lists

    g = torch.Generator().manual_seed(34)
    args, kw = _deep_inputs(schedule, dtype, True, kk, g, leg)
    card = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
    kw_card = {n: a.to(cuda) if torch.is_tensor(a) else a for n, a in kw.items()}
    kernel = getattr(ivf_scan, f"ivf_scan_{schedule}")
    with pytest.raises(ValueError, match="f32"):
        kernel(*card, scan_dtype="bfloat16", **kw_card)
    # repad the lists to a page multiple, as paginate_index does
    data, y2, ids = args[3:6]
    cap2 = -(-data.shape[1] // page_rows) * page_rows
    pad = cap2 - data.shape[1]
    mono = card[:3] + [torch.nn.functional.pad(data, (0, 0, 0, pad)).to(cuda),
                       torch.nn.functional.pad(y2, (0, pad)).to(cuda),
                       torch.nn.functional.pad(ids, (0, pad), value=-1).to(cuda), kk]
    pag = mono[:3] + [_on(paged_lists(mono[3].cpu(), page_rows, 4), cuda)] + mono[4:]
    if "list_filter" in kw_card:
        lf = kw_card["list_filter"]
        kw_card["list_filter"] = torch.nn.functional.pad(lf, (0, -(-cap2 // 32) - lf.shape[-1]))
    plain = getattr(ivf_scan, f"ivf_scan_{schedule}_torch")
    want = plain(*pag, **kw_card)
    unpaged = kernel(*mono, **kw_card)
    kernels.reset_launch_counts()
    got = kernel(*pag, **kw_card)
    torch.cuda.synchronize()
    name = ivf_scan.kernel_name(schedule, pag[3], kw_card.get("list_filter"),
                                kw_card.get("query_fid"), scan_scale=None)
    suffix = "_u8_paged" if dtype == torch.uint8 else "_s8_paged"
    assert suffix in name and name in kernels.KERNELS
    assert {n: c for n, c in kernels.launch_counts().items() if c} == {name: 1}
    for a, b, c in zip(got, want, unpaged):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [513, 1024, 2048])
def test_select_k_and_fused_knn_past_512_match_plain(cuda, k):
    """select_k (#1) and fused_knn (#2) at k past the former 512: select_k
    bitwise in both tie disciplines; fused_knn bitwise (fewer queries a
    block, and the split batch's merge at k)."""
    g = torch.Generator().manual_seed(35)
    s = torch.round(torch.randn(40, 4000, generator=g) * 3)
    ids = torch.randint(-1, 400, (40, 4000), generator=g, dtype=torch.int32)
    for stable in (False, True):
        want = select_k.select_k_torch(s, k, stable=stable, input_indices=ids)
        got = select_k.select_k_kernel(s.to(cuda), k, stable=stable, input_indices=ids.to(cuda))
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    x, q = torch.randn(20000, 32, generator=g), torch.randn(70, 32, generator=g)
    xx = (x * x).sum(1)
    want = fused_knn.fused_l2_topk_torch(q.to(cuda), x.to(cuda), xx.to(cuda), k)
    kernels.reset_launch_counts()
    got = fused_knn.fused_l2_topk(q.to(cuda), x.to(cuda), xx.to(cuda), k)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_knn"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_centers,d", [(1100, 300, 40), (8192, 1024, 128), (5, 1, 3),
                                           (70, 129, 64), (8191, 1029, 128), (1000, 1000, 64),
                                           (2000, 1300, 30), (129, 2500, 32), (300, 777, 30)])
def test_fused_argmin_kernel_matches_plain_bitwise(cuda, n, n_centers, d):
    """Kernel #7 against its plain version on the card: scores and ids
    bitwise, with duplicate centers (a tie the first must win, within a
    part and across parts), a +inf norm (a center that never wins), rows
    and centers off the 128 x 128 tile, d off the float4 stages (d = 30:
    one float a copy), and shapes cut into several center parts."""
    from raft_tpu_torch.kernels import fused_argmin

    g = torch.Generator().manual_seed(36)
    x = torch.randn(n, d, generator=g)
    c = torch.randn(n_centers, d, generator=g)
    if n_centers > 2:
        c[n_centers - 1] = c[n_centers // 2]          # a duplicate, later index
        x[0] = c[n_centers // 2]
    parts, chunk = fused_argmin.center_parts(
        n, n_centers, fused_argmin._BLOCKS_PER_SM * kernels.sm_count(cuda.index or 0))
    if parts > 1:   # a duplicate of a center of the first part, first in the last part
        c[(parts - 1) * chunk] = c[5]
        x[1] = c[5]
    cc = (c * c).sum(1)
    if n_centers > 3:
        cc[1] = float("inf")
    from raft_tpu_torch.ops import cost

    want = fused_argmin.fused_l2_argmin_torch(x.to(cuda), c.to(cuda), cc.to(cuda))
    kernels.reset_launch_counts()
    with cost.capture() as notes:
        got = kernels.fused_l2_argmin(x.to(cuda), c.to(cuda), cc.to(cuda))
    torch.cuda.synchronize()
    assert {n_: c_ for n_, c_ in kernels.launch_counts().items() if c_} == {"fused_argmin": 1}
    assert notes == [("fused_argmin", cost.fused_argmin_cost(n, n_centers, d))]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if n_centers > 2:
        assert int(got[1][0]) == n_centers // 2      # the first of the duplicates
    if parts > 1:
        assert int(got[1][1]) == 5
    if n_centers > 3:
        assert not bool((got[1] == 1).any())         # the +inf center never wins


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_centers", [(8192, 1024), (300, 129), (70, 5)])
def test_fused_argmin_kernel_rows_of_infinite_scores(cuda, n, n_centers):
    """Every center's norm +inf: every row's scores are +inf, and the
    kernel keeps (+inf, 0) as its plain version (and the TPU kernel's
    initial block) does, across parts too."""
    from raft_tpu_torch.kernels import fused_argmin

    g = torch.Generator().manual_seed(38)
    x, c = torch.randn(n, 64, generator=g), torch.randn(n_centers, 64, generator=g)
    cc = torch.full((n_centers,), float("inf"))
    want = fused_argmin.fused_l2_argmin_torch(x, c, cc)
    got = kernels.fused_l2_argmin(x.to(cuda), c.to(cuda), cc.to(cuda))
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert bool(torch.isinf(got[0]).all()) and not bool(got[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.bfloat16])
def test_ivf_flat_8bit_and_bf16_search_on_the_card(cuda, dtype):
    """IVF-Flat over uint8 / int8 / bf16 rows on the card: both schedules
    on the storage type's kernel leg (no plain scan), ids and distances
    bitwise the CPU search of the same index."""
    rng = np.random.default_rng(37)
    lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
    centers = rng.integers(lo + 40, hi - 40, (40, 32))
    x = np.clip(centers[rng.integers(0, 40, 6000)] + rng.integers(-20, 20, (6000, 32)), lo, hi - 1)
    q = np.clip(centers[rng.integers(0, 40, 300)] + rng.integers(-20, 20, (300, 32)), lo, hi - 1)
    xt = torch.from_numpy(x).to(dtype)
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=16, kmeans_n_iters=4), xt.to(cuda),
                         res=Resources(device="cuda"))
    assert idx.list_data.dtype == dtype
    host = ivf_flat.Index(idx.metric, idx.centers.cpu(), idx.list_data.cpu(),
                          idx.list_index.cpu(), idx.list_sizes.cpu(), idx.list_norms.cpu())
    leg = {torch.uint8: "_u8", torch.int8: "_s8", torch.bfloat16: "_bf16"}[dtype]
    for strategy in ("query_major", "probe_major"):
        sp = ivf_flat.SearchParams(n_probes=6, strategy=strategy)
        kernels.reset_launch_counts()
        v, i = ivf_flat.search(sp, idx, q.astype(np.float32), 10)
        torch.cuda.synchronize()
        assert kernels.launch_counts()[f"ivf_scan_{strategy}{leg}"] > 0
        pv, pi = ivf_flat.search(sp, host, q.astype(np.float32), 10, res=Resources(device="cpu"))
        assert torch.equal(i.cpu(), pi) and torch.equal(v.cpu(), pv)


@pytest.mark.cuda
def test_threads_on_their_own_streams_search_one_paged_index(cuda):
    """Four threads, each on its own CUDA stream, searching one IVF-Flat
    index whose pool holds a quarter of its pages: every result bitwise the
    monolithic search (the store's search guard orders the streams)."""
    import copy
    import threading

    from raft_tpu_torch.store import MemoryBudget, paginate_index

    rng = np.random.default_rng(38)
    x = rng.standard_normal((6000, 32)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)).to(cuda)
    res = Resources(device="cuda")
    flat = ivf_flat.build(ivf_flat.IndexParams(n_lists=32), x, res=res)
    over = copy.copy(flat)
    ppl = -(-flat.list_cap // 64)
    n_pages = flat.n_lists * ppl
    tiered = paginate_index(over, page_rows=64,
                            budget=MemoryBudget(n_pages // 4 * 64 * 32 * 4 + 4 * n_pages))
    sp = ivf_flat.SearchParams(n_probes=4)
    batches = [q[s:s + 1] for s in range(24)]   # a batch's pages must fit the pool
    want = [ivf_flat.search(sp, flat, b, 10, res=res) for b in batches]
    torch.cuda.synchronize()   # the threads' streams do not wait for this one
    out = [[] for _ in range(4)]
    errors = []

    def worker(t):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                for r in range(3):
                    for b in range(len(batches)):
                        i = (b + 6 * t + r) % len(batches)
                        v, ids = ivf_flat.search(sp, over, batches[i], 10, res=res)
                        out[t].append((i, v.cpu(), ids.cpu()))   # synchronises this stream
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == []
    for per in out:
        assert len(per) == 3 * len(batches)
        for i, v, ids in per:
            assert torch.equal(v, want[i][0].cpu()) and torch.equal(ids, want[i][1].cpu())
    assert tiered.evictions > 0


# -- query-major (#5 / #6) and the CAGRA walk (#8), redesigned -----------------

#: query-major storage legs: (rows dtype, scan_dtype, scan_scale)
_QM_LEGS = {
    "f32": (torch.float32, "float32", 1.0), "f32_bf16c": (torch.float32, "bfloat16", 1.0),
    "bf16": (torch.bfloat16, "float32", 1.0), "bf16_bf16c": (torch.bfloat16, "bfloat16", 1.0),
    "int8": (torch.int8, "float32", 0.0173), "u8": (torch.uint8, "float32", None),
    "s8": (torch.int8, "float32", None),
}


def _qm_inputs(leg, filt, g, *, L=16, cap=320, real=250, d=64, Q=9, P=10):
    """Query-major card inputs: 16 lists of 320 slots (250 real; 5 pages of
    64), list 1 repeating one row 11 times (ties by position), list 2 with 6
    zero rows (-0.0 inner-product scores), query 0 probing list 2 only, so
    that up to 2,500 real rows face kk = 2048.  ``filt`` None, "filt" (one
    plane passing ~40 %) or "fid" (5 planes and each query's plane)."""
    from raft_tpu_torch.core.bitset import Bitset

    dtype, scan_dtype, scale = _QM_LEGS[leg]
    if dtype in (torch.int8, torch.uint8):
        lo, hi = (0, 256) if dtype == torch.uint8 else (-127, 128)
        data = torch.randint(lo, hi, (L, cap, d), generator=g).to(dtype)
    else:
        data = torch.randn(L, cap, d, generator=g).to(dtype)
    data[1, 10:20] = data[1, 0]
    data[2, :6] = 0
    vals = data.float() * (torch.tensor(scale, dtype=torch.float32) if leg == "int8" else 1.0)
    ids = torch.arange(L * cap, dtype=torch.int32).reshape(L, cap)
    ids[:, real:] = -1
    y2 = torch.where(ids >= 0, (vals * vals).sum(-1), torch.zeros(()))
    probes = torch.randint(0, L, (Q, P), generator=g, dtype=torch.int32)
    probes[0] = 2
    q = torch.randn(Q, d, generator=g)
    kw = dict(scan_dtype=scan_dtype, scan_scale=scale)
    if filt is not None:
        planes = 1 if filt == "filt" else 5
        masks = torch.rand(planes, L * cap, generator=g) < 0.4
        table = torch.stack([ivf_scan.pack_list_filter(ids, Bitset.from_mask(m, device="cpu").words)
                             for m in masks])
        kw["list_filter"] = table[0] if filt == "filt" else table
        if filt == "fid":
            kw["query_fid"] = torch.randint(0, planes, (Q,), generator=g, dtype=torch.int32)
    return (probes, q, (q * q).sum(1), data, y2, ids), kw


def _bits_equal(a, b):
    return torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("kk", [10, 129, 1000, 2048])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("filt", [None, "filt", "fid"])
@pytest.mark.parametrize("leg", list(_QM_LEGS))
def test_query_major_redesign_matches_plain_bitwise(cuda, leg, filt, paged, kk, splits,
                                                   monkeypatch):
    """Every query-major leg (#5, and #6 = the "fid" leg) against its plain
    version on the card, values by their bits: each storage type and
    product, unfiltered / one plane / each query's plane, monolithic and
    through a scattered page table, at kk 10 to 2048 (past the rows a
    filtered query has), one part and three parts merged (merge_parts past
    k = 128 is the radix-select merge)."""
    from _torch_parity import paged_lists

    g = torch.Generator().manual_seed(40)
    args, kw = _qm_inputs(leg, filt, g)
    card = [a.to(cuda) for a in args]
    if paged:
        card[3] = _on(paged_lists(args[3], 64, 41), cuda)
    kw_card = {n: a.to(cuda) if torch.is_tensor(a) else a for n, a in kw.items()}
    name = ivf_scan.kernel_name("query_major", card[3], kw_card.get("list_filter"),
                                kw_card.get("query_fid"), kw["scan_scale"])
    monkeypatch.setattr(kernels, "grid_splits", lambda *a, **kw: splits)
    for metric in ("sqeuclidean", "inner_product"):
        want = ivf_scan.ivf_scan_query_major_torch(*card, kk, metric=metric, **kw_card)
        kernels.reset_launch_counts()
        got = ivf_scan.ivf_scan_query_major(*card, kk, metric=metric, **kw_card)
        torch.cuda.synchronize()
        assert {n: c for n, c in kernels.launch_counts().items() if c} == {name: 1}
        assert _bits_equal(got, want), (metric, name)
        assert bool(torch.isfinite(got[0][:, 0]).all())
    if kk == 2048 and filt is not None:   # fewer passing rows than kk: +inf / -1 tails
        assert bool((got[1][:, -1] == -1).all())


def _walk_inputs_card(seed, metric, itopk, exhaust):
    """Walk inputs: 4,000 rows of d 128.  Unless ``exhaust``, a random graph
    of degree 64 with a repeated id in every list and ~5 % missing
    neighbours; with ``exhaust``, degree 16 within groups of 32 rows and
    each query seeded inside one group, so every frontier runs out early."""
    rng = np.random.default_rng(seed)
    n, d, tile = 4000, 128, 64
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((tile, d)).astype(np.float32))
    if exhaust:
        deg = 16
        base = (np.arange(n) // 32 * 32)[:, None]
        graph = base + (np.arange(n)[:, None] + 1 + np.arange(deg)[None, :]) % 32
        seeds = (rng.integers(0, n // 32, tile)[:, None] * 32
                 + rng.integers(0, 32, (tile, itopk + 8)))
    else:
        deg = 64
        graph = rng.integers(0, n, (n, deg))
        graph[:, -1] = graph[:, 0]
        graph[rng.random((n, deg)) < 0.05] = -1
        seeds = rng.integers(0, n, (tile, itopk + 8))
    graph = torch.from_numpy(graph.astype(np.int32))
    buf = cagra.traverse_init(x, q, torch.from_numpy(seeds.astype(np.int32)), itopk, metric)
    return x, graph, q, buf


@pytest.mark.cuda
@pytest.mark.parametrize("exhaust", [False, True])
@pytest.mark.parametrize("width,itopk", [(w, i) for w in (1, 2, 4) for i in (16, 64, 129, 512)]
                         + [(w, i) for w in (33, 64) for i in (129, 512)])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [False, True])
def test_walk_kernel_matches_plain_bitwise(cuda, paged, dtype, metric, width, itopk, exhaust):
    """#8 as one launch (``cagra_traverse_steps``) against the hop-by-hop
    loop of the plain pick and hop on the card: values by their bits, ids,
    explored flags, live-parent and fetched-row counts equal, dense and
    through a scattered page table, at widths past one warp of parents;
    ``exhaust``: frontiers that run out early."""
    from _torch_parity import paged_rows

    x, graph, q, buf = _walk_inputs_card(50, metric, itopk, exhaust)
    x = x.to(dtype)
    rest = [a.to(cuda) for a in (graph, q, *buf)]
    rows = _on(paged_rows(x, 64, 51), cuda) if paged else x.to(cuda)
    steps = 40 if exhaust else 12
    want = cagra_traverse.cagra_traverse_steps_torch(rows, *rest, steps=steps, width=width,
                                                     metric=metric)
    kernels.reset_launch_counts()
    got = cagra_traverse.cagra_traverse_steps(rows, *rest, steps=steps, width=width,
                                              metric=metric)
    torch.cuda.synchronize()
    name = "cagra_traverse_paged" if paged else "cagra_traverse"
    assert {n: c for n, c in kernels.launch_counts().items() if c} == {name: 1}
    assert kernels.consume_kernel_path() == "cuda"
    assert _bits_equal(got[:2], want[:2])
    assert all(torch.equal(got[j], want[j]) for j in (2, 3, 4))
    assert bool((got[4] < got[3] * graph.shape[1]).all())
    if exhaust:
        assert bool((got[3] < steps * width).all()) and bool(got[2].all())
    else:
        assert not torch.equal(got[1], rest[3])


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 40])
@pytest.mark.parametrize("paged", [False, True])
def test_cagra_search_is_bitwise_its_plain_versions(cuda, paged, width, monkeypatch):
    """neighbors.cagra.search on the card: one walk launch per query tile and
    no hop or per-hop select_k launch; results bitwise the same search with
    every kernel replaced by its plain version, at two parents a hop and at
    more than one warp holds."""
    import copy

    from raft_tpu_torch.neighbors import cagra as ncagra
    from raft_tpu_torch.store import paginate_index

    rng = np.random.default_rng(52)
    x = rng.standard_normal((5000, 48)).astype(np.float32)
    q = rng.standard_normal((230, 48)).astype(np.float32)
    res = Resources(device="cuda")
    idx = cagra.build(cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16,
                                        build_algo="brute_force"), x, res=res)
    if paged:
        idx = copy.copy(idx)
        paginate_index(idx, page_rows=64, budget=None)
    sp = cagra.SearchParams(itopk_size=64, search_width=width, max_queries=100)
    _, max_iter, tile = cagra.search_plan(sp, idx, q.shape[0], 10)
    kernels.reset_launch_counts()
    got = cagra.search(sp, idx, q, 10, res=res)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    tiles = -(-q.shape[0] // tile)
    walk = "cagra_traverse_paged" if paged else "cagra_traverse"
    assert counts[walk] == tiles and counts["cagra_fused_hop"] == counts["cagra_fused_hop_paged"] == 0
    assert counts["select_k"] <= 2 * tiles + 1 < max_iter
    monkeypatch.setattr(ncagra, "cagra_traverse_steps", cagra_traverse.cagra_traverse_steps_torch)
    monkeypatch.setattr(select_k, "select_k_kernel",
                        lambda *a, **kw: select_k.select_k_torch(*a, **kw))
    kernels.reset_launch_counts()
    want = cagra.search(sp, idx, q, 10, res=res)
    assert sum(kernels.launch_counts().values()) == 0
    assert _bits_equal(got, want)


def test_import_check_covers_the_bench():
    bench = [p for p in PORT_FILES if "bench" in p.relative_to(REPO).parts]
    assert {p.name for p in bench} >= {"datasets.py", "device_time.py", "runner.py", "export.py",
                                       "conf.py", "ladder.py", "prims.py", "__main__.py"}
    assert not [m for p in bench for m in _imported_modules(p) if _forbidden(m)]


def test_import_check_covers_the_graph_and_sparse_slice():
    """The import walk reaches every module of the sparse / graph slice."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for mod in ("sparse/__init__", "sparse/formats", "sparse/convert", "sparse/op",
                "sparse/linalg", "sparse/distance", "sparse/neighbors", "sparse/solver",
                "ops/lanczos", "ops/linalg", "cluster/spectral", "cluster/single_linkage",
                "cluster/auto_find_k", "label/classlabels", "label/merge_labels",
                "solver/linear_assignment", "random/rng", "random/datagen", "distance/kernels",
                "kernels/csr_spmm"):
        assert f"raft_tpu_torch/{mod}.py" in names, mod


def test_graph_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    from raft_tpu_torch import random as trandom
    from raft_tpu_torch.cluster import find_k, single_linkage, spectral
    from raft_tpu_torch.distance import gram_matrix
    from raft_tpu_torch.ops.lanczos import eigsh_lanczos
    from raft_tpu_torch.solver import linear_assignment
    from raft_tpu_torch.sparse import COO, CSR, distance, neighbors, solver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 4)).astype(np.float32)
    cpu = Resources(device="cpu")
    a = torch.eye(6)
    calls = [
        lambda **kw: neighbors.knn_graph(x, 3, **kw),
        lambda **kw: single_linkage(x, n_clusters=2, c=3, **kw),
        lambda **kw: find_k(x, 3, **kw),
        lambda **kw: linear_assignment(x[:4, :4], **kw),
        lambda **kw: gram_matrix(x, **kw),
        lambda **kw: eigsh_lanczos(lambda v: a.to(v.device) @ v, 6, 2, m=6, **kw),
        lambda **kw: trandom.make_blobs(torch.Generator().manual_seed(0), 10, 2, **kw),
        lambda **kw: distance.pairwise_distance_sparse(CSR.from_dense(x, device="cpu"),
                                                       CSR.from_dense(x, device="cpu"), **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(res=cpu)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        COO(np.zeros(1, np.int32), np.zeros(1, np.int32), np.ones(1, np.float32), (2, 2))
    g = neighbors.knn_graph(x, 3, res=cpu)
    for call in (lambda **kw: spectral.partition(g, 2, **kw),
                 lambda **kw: spectral.modularity_maximization(g, 2, **kw),
                 lambda **kw: solver.mst(g, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(res=cpu)


def test_csr_spmm_work_counts_each_input_once():
    from raft_tpu_torch.ops import cost

    w = cost.csr_spmm_work(1000, 30000, 1000, 1)
    assert w.flops == 2 * 30000
    assert w.bytes_accessed == 4 * 1001 + 8 * 30000 + 4 * 1000 + 4 * 1000
    ms, by = cost.bound_ms(w)
    assert by == "bytes" and ms == pytest.approx(w.bytes_accessed / cost.H100_BYTES_PER_S * 1e3)


def _graph_csr(n, seed, hub_degree=0, cols=1):
    """A CSR of power-law row degrees (empty rows included; one hub row of
    ``hub_degree`` slots) with signed values over several magnitudes."""
    g = torch.Generator().manual_seed(seed)
    deg = torch.clamp((torch.rand(n, generator=g) ** -1.5).long() - 1, max=400)
    if hub_degree:
        deg[n // 2] = hub_degree
    indptr = torch.zeros(n + 1, dtype=torch.int32)
    indptr[1:] = torch.cumsum(deg, 0).to(torch.int32)
    nnz = int(indptr[-1])
    idx = torch.randint(0, n, (nnz,), generator=g, dtype=torch.int32)
    data = torch.randn(nnz, generator=g) * 10.0 ** torch.randint(-3, 4, (nnz,), generator=g)
    x = torch.randn((n, cols), generator=g)
    return indptr, idx, data, x


@pytest.mark.cuda
@pytest.mark.parametrize("n,hub,cols", [(1000, 0, 1), (5000, 30000, 1), (3000, 2000, 3),
                                        (1, 0, 1), (20000, 70000, 1), (3000, 300, 32),
                                        (2000, 3000, 33), (4000, 0, 128)])
def test_csr_spmm_kernel_matches_plain_bitwise(cuda, n, hub, cols):
    from raft_tpu_torch.kernels import csr_spmm

    indptr, idx, data, x = _graph_csr(n, n + hub, hub, cols)
    want = csr_spmm.csr_spmm_torch(indptr, idx, data, x)
    kernels.reset_launch_counts()
    got = csr_spmm.csr_spmm(indptr.to(cuda), idx.to(cuda), data.to(cuda), x.to(cuda))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["csr_spmm"] == 1
    assert kernels.consume_kernel_path() == "cuda"
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    again = csr_spmm.csr_spmm(indptr.to(cuda), idx.to(cuda), data.to(cuda), x.to(cuda))
    assert torch.equal(got, again)


def _schedule_csr(case, seed):
    """A CSR shaped after a branch of ``csrc/csr_spmm.cu``'s plan: "empty"
    (most rows empty, whole windows of them), "degrees" (rows of 1, 31, 32
    and 33 slots), "long" (one row of 5,000 slots among short rows),
    "keys" (k-means' centroid sums: 20,000 rows into 7 keys, one empty)."""
    rng = np.random.default_rng(seed)
    if case == "empty":
        deg = np.where(rng.random(3000) < 0.1, rng.integers(1, 9, 3000), 0)
        deg[256:2000] = 0
    elif case == "degrees":
        deg = np.tile([1, 31, 32, 33, 0], 600)
    elif case == "long":
        deg = rng.integers(0, 40, 3000)
        deg[1370] = 5000
    else:
        deg = np.bincount(rng.choice([0, 1, 2, 3, 5, 6], 20000), minlength=7)
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32))
    nnz = int(indptr[-1])
    idx = torch.from_numpy(rng.integers(0, 5000, nnz).astype(np.int32))
    data = torch.from_numpy(
        (rng.standard_normal(nnz) * 10.0 ** rng.integers(-3, 4, nnz)).astype(np.float32))
    return indptr, idx, data


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [1, 3, 32, 33, 128])
@pytest.mark.parametrize("case", ["empty", "degrees", "long", "keys"])
def test_csr_spmm_kernel_plan_cases_bitwise(cuda, case, cols):
    """The kernel bitwise its plain version on every branch of its plan:
    windows of empty rows, warp-round edges, a long row in a block of its
    own (one column) or the ring (more columns), and many rows a key."""
    from raft_tpu_torch.kernels import csr_spmm

    indptr, idx, data = _schedule_csr(case, cols)
    x = torch.from_numpy(np.random.default_rng(cols).standard_normal((5000, cols)).astype(
        np.float32))
    want = csr_spmm.csr_spmm_torch(indptr, idx, data, x)
    got = csr_spmm.csr_spmm(*(t.to(cuda) for t in (indptr, idx, data, x)))
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.cuda
def test_spectral_partition_on_the_card_is_bitwise_its_plain_spmv(cuda, monkeypatch):
    """Laplacian, Lanczos and k-means on the card: the csr_spmm kernel
    launched, two runs bitwise equal, and equal to the same call with the
    kernel replaced by its plain version."""
    from raft_tpu_torch.cluster import spectral
    from raft_tpu_torch.kernels import csr_spmm
    from raft_tpu_torch.sparse import neighbors

    rng = np.random.default_rng(4)
    centers = rng.uniform(0, 10, (4, 6))
    x = (centers[rng.integers(0, 4, 2000)] + 0.4 * rng.standard_normal((2000, 6))).astype(
        np.float32)
    g = neighbors.knn_graph(x, 10, res=Resources(device="cpu"))
    g.data = 1.0 / (1.0 + g.data)
    res = Resources(device="cuda")
    kernels.reset_launch_counts()
    l1, v1 = spectral.partition(g, 4, res=res)
    assert kernels.launch_counts()["csr_spmm"] > 0
    l2, v2 = spectral.partition(g, 4, res=res)
    assert torch.equal(l1, l2) and torch.equal(v1, v2)
    monkeypatch.setattr(csr_spmm, "csr_spmm", csr_spmm.csr_spmm_torch)
    kernels.reset_launch_counts()
    l3, v3 = spectral.partition(g, 4, res=res)
    assert kernels.launch_counts()["csr_spmm"] == 0
    assert torch.equal(l1, l3) and torch.equal(v1, v3)


def _rows8(x: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the same shape as ``x`` holding seeded 8-bit values."""
    g = torch.Generator().manual_seed(61)
    lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
    return torch.randint(lo, hi, tuple(x.shape), generator=g).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("width,itopk", [(1, 16), (1, 64), (4, 129), (33, 512)])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
@pytest.mark.parametrize("paged", [False, True])
def test_walk_kernel_8bit_legs_match_plain_bitwise(cuda, paged, dtype, metric, width, itopk):
    """#8's 8-bit legs (uint8 / int8 rows, each value converted exactly to
    f32 where it is staged), dense and through a scattered page table,
    against the plain loop of pick and hop on the card: values by their
    bits, ids, flags, live parents and fetched rows; under the launch
    names of the f32 and bf16 rows."""
    from _torch_parity import paged_rows

    x, graph, q, _ = _walk_inputs_card(62, metric, itopk, False)
    x8 = _rows8(x, dtype)
    rng = np.random.default_rng(63)
    seeds = torch.from_numpy(rng.integers(0, x.shape[0], (q.shape[0], itopk + 8)).astype(np.int32))
    buf = cagra.traverse_init(x8, q, seeds, itopk, metric)
    rest = [a.to(cuda) for a in (graph, q, *buf)]
    rows = _on(paged_rows(x8, 64, 64), cuda) if paged else x8.to(cuda)
    want = cagra_traverse.cagra_traverse_steps_torch(rows, *rest, steps=12, width=width,
                                                     metric=metric)
    kernels.reset_launch_counts()
    got = cagra_traverse.cagra_traverse_steps(rows, *rest, steps=12, width=width, metric=metric)
    torch.cuda.synchronize()
    name = "cagra_traverse_paged" if paged else "cagra_traverse"
    assert {n: c for n, c in kernels.launch_counts().items() if c} == {name: 1}
    assert _bits_equal(got[:2], want[:2])
    assert all(torch.equal(got[j], want[j]) for j in (2, 3, 4))
    assert not torch.equal(got[1], rest[3])


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
@pytest.mark.parametrize("paged", [False, True])
def test_hop_kernel_8bit_legs_match_plain_bitwise(cuda, paged, dtype, metric):
    """The single hop (``rt_cagra_hop``) on 8-bit rows, dense and paged:
    bitwise its plain version, and the paged leg bitwise the dense one."""
    from _torch_parity import paged_rows

    x, graph, q, *_ = hop_inputs(9, metric, n=4000, d=128, deg=64, tile=300, itopk=64, width=2)
    x8 = _rows8(x, dtype)
    seeds = np.random.default_rng(67).integers(0, x.shape[0], (q.shape[0], 72))
    buf = cagra.traverse_init(x8, q, torch.from_numpy(seeds.astype(np.int32)), 64, metric)
    parents, explored = cagra_traverse.pick_parents(*buf, 2)
    rest = [a.to(cuda) for a in (graph, q, parents, buf[0], buf[1], explored)]
    rows = _on(paged_rows(x8, 8, 65), cuda) if paged else x8.to(cuda)
    want = cagra_traverse.cagra_fused_hop_torch(rows, *rest, metric=metric)
    kernels.reset_launch_counts()
    got = cagra_traverse.cagra_fused_hop(rows, *rest, metric=metric)
    torch.cuda.synchronize()
    name = "cagra_fused_hop_paged" if paged else "cagra_fused_hop"
    assert {n: c for n, c in kernels.launch_counts().items() if c} == {name: 1}
    dense = cagra_traverse.cagra_fused_hop(x8.to(cuda), *rest, metric=metric)
    for a, b, c in zip(got, want, dense):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(got[1], rest[4])


@pytest.mark.cuda
def test_cagra_8bit_search_on_the_card_is_bitwise_its_plain_versions(cuda, monkeypatch):
    """A uint8 CAGRA index built on the card keeps 1 byte a value; its search
    runs one walk launch per tile and is bitwise the same search with every
    kernel replaced by its plain version."""
    rng = np.random.default_rng(66)
    x = rng.integers(0, 256, (5000, 48)).astype(np.uint8)
    q = rng.integers(0, 256, (230, 48)).astype(np.float32)
    res = Resources(device="cuda")
    idx = cagra.build(cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16), x,
                      res=res)
    assert idx.dataset.dtype == torch.uint8 and idx.dataset.is_cuda
    sp = cagra.SearchParams(itopk_size=64, max_queries=100)
    kernels.reset_launch_counts()
    got = cagra.search(sp, idx, q, 10, res=res)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["cagra_traverse"] == 3
    from raft_tpu_torch.neighbors import cagra as ncagra

    monkeypatch.setattr(ncagra, "cagra_traverse_steps", cagra_traverse.cagra_traverse_steps_torch)
    monkeypatch.setattr(select_k, "select_k_kernel",
                        lambda *a, **kw: select_k.select_k_torch(*a, **kw))
    want = cagra.search(sp, idx, q, 10, res=res)
    assert _bits_equal(got, want)


@pytest.mark.cuda
def test_measure_device_time_is_busy_time_within_the_wall(cuda):
    """``bench.device_time.measure_device_time`` on the card: a positive busy
    time, no larger than the wall time of the same call."""
    import time

    from raft_tpu_torch.bench.device_time import card, measure_device_time

    x = torch.randn(20000, 128, device=cuda)
    q = torch.randn(2000, 128, device=cuda)
    res = Resources(device="cuda")
    brute_force.knn(x, q, 10, res=res)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    brute_force.knn(x, q, 10, res=res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = measure_device_time(lambda a, b: brute_force.knn(a, b, 10, res=res), x, q)
    assert busy is not None and 0 < busy
    t0 = time.perf_counter()
    busy2 = measure_device_time(lambda a, b: brute_force.knn(a, b, 10, res=res), x, q)
    assert busy2 <= time.perf_counter() - t0
    info = card(cuda)
    assert info["name"] == torch.cuda.get_device_name(0) and info["power_limit"]
