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
from raft_tpu_torch.kernels import fused_knn, ivf_scan, select_k
from raft_tpu_torch.neighbors import brute_force, ivf_flat

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "raft_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


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
    kernels.reset_launch_counts()


# -- on the card ---------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("select_k_cost", (10000, 1104, 20)),
    ("ivf_scan_cost", (1376, 256, 1960, 128, 10)),
    ("fused_knn_cost", (256, 1000000, 128, 10)),
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
def test_select_k_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(0)
    s = torch.round(torch.randn(300, 1000, generator=g) * 3)
    ids = torch.randint(-1, 40, (300, 1000), generator=g, dtype=torch.int32)
    for stable in (False, True):
        want = select_k.select_k_torch(s, 16, stable=stable, input_indices=ids)
        got = select_k.select_k_kernel(s.to(cuda), 16, stable=stable,
                                       input_indices=ids.to(cuda))
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_fused_knn_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(1)
    x, q = torch.randn(20000, 64, generator=g), torch.randn(70, 64, generator=g)
    xx = (x * x).sum(1)
    want = fused_knn.fused_l2_topk_torch(q, x, xx, 10)
    got = fused_knn.fused_l2_topk(q.to(cuda), x.to(cuda), xx.to(cuda), 10)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-4)
    assert (got[1].cpu() == want[1]).float().mean() >= 0.999


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
