"""Hand-written Hopper kernels and their plumbing (counterpart of
``raft_tpu.kernels``).

- ``stamp_kernel_path`` / ``consume_kernel_path``: each routing branch
  stamps the leg it took, ``"cuda"`` (a kernel of ``csrc/``) or
  ``"torch"`` (the plain PyTorch version), as raft_tpu's branches stamp
  ``"pallas"`` / ``"xla"``.
- Launch counts: every wrapper adds one to its kernel's count where it
  launches the kernel and nowhere else; :func:`launch_counts` reads them.
- :func:`library`: builds ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into
  one shared library under ``_build/`` (keyed on a hash of the sources, so
  an edit rebuilds) and loads it with ``ctypes``.  Nothing is built or
  loaded at import: the CPU tests import every module.  Each source's
  compile and the library's load are counted in ``obs.device_events``
  (families ``backend_compile`` and ``cache_hit`` / ``cache_miss``).
- :data:`TRACE_NAMES`: the CUDA kernel each counted launch runs once, as
  ``torch.profiler`` names it (``bench.device_time`` holds a traced window
  to the launches made in it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# ---------------------------------------------------------------------------
# kernel-path attribution

_kernel_path_tls = threading.local()


def stamp_kernel_path(path: str) -> None:
    """Record which leg the current search call routed to."""
    _kernel_path_tls.value = path


def consume_kernel_path(default: str = "unknown") -> str:
    """Pop the stamp left by the last search on this thread."""
    path = getattr(_kernel_path_tls, "value", None)
    _kernel_path_tls.value = None
    return path if path is not None else default


# ---------------------------------------------------------------------------
# launch counts

KERNELS = (
    "select_k", "fused_knn", "ivf_scan_probe_major", "ivf_scan_query_major",
    "ivf_scan_probe_major_bf16", "ivf_scan_probe_major_int8",
    "ivf_scan_query_major_bf16", "ivf_scan_query_major_int8", "cagra_fused_hop",
    # the filter legs of the scans: one plane of pass words (_filt), or each
    # query's own plane of a table (_fid, query-major only)
    "ivf_scan_probe_major_filt", "ivf_scan_probe_major_bf16_filt",
    "ivf_scan_probe_major_int8_filt", "ivf_scan_query_major_filt",
    "ivf_scan_query_major_bf16_filt", "ivf_scan_query_major_int8_filt",
    "ivf_scan_query_major_fid", "ivf_scan_query_major_bf16_fid",
    "ivf_scan_query_major_int8_fid",
    # the paged legs (lists read through a page table, store.PagedLists;
    # rows through one, store.PagedRows): _paged after the storage suffix
    *(f"ivf_scan_{schedule}{dtype}_paged{leg}"
      for schedule, legs in (("probe_major", ("", "_filt")),
                             ("query_major", ("", "_filt", "_fid")))
      for dtype in ("", "_bf16", "_int8") for leg in legs),
    "cagra_fused_hop_paged",
    # raw 8-bit rows (IVF-Flat over a uint8 / int8 dataset), unpaged and paged
    *(f"ivf_scan_{schedule}{dtype}{paged}{leg}"
      for schedule, legs in (("probe_major", ("", "_filt")),
                             ("query_major", ("", "_filt", "_fid")))
      for dtype in ("_u8", "_s8") for paged in ("", "_paged") for leg in legs),
    "fused_argmin",
    # a CAGRA tile's whole walk in one launch (dense rows, and rows through
    # a page table)
    "cagra_traverse", "cagra_traverse_paged",
    # deterministic CSR x dense sums (no TPU kernel: raft_tpu's segment_sum)
    "csr_spmm",
)
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_launch_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _launch_lock:
        _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in _launches:
            _launches[name] = 0


#: (launch-count prefix, part of the CUDA kernel's name in a profiler trace):
#: each counted launch runs its C entry once, and the entry launches that
#: kernel exactly once (besides helpers such as merges and final passes)
TRACE_NAMES = (
    ("select_k", "select_k_"),              # select_k_warp_kernel / _sort_kernel
    ("fused_knn", "fused_knn_kernel"),
    ("ivf_scan_probe_major", "probe_major_"),
    ("ivf_scan_query_major", "query_major_"),
    ("cagra_", "cagra_walk_kernel"),        # the hop and the walk
    ("fused_argmin", "fused_argmin_kernel"),
    ("csr_spmm", "csr_spmm_kernel"),
)


def trace_name(launch: str) -> str:
    """The part of the CUDA kernel's name that one counted ``launch`` puts
    in a profiler trace."""
    for prefix, name in TRACE_NAMES:
        if launch.startswith(prefix):
            return name
    raise KeyError(f"no trace name for launch {launch!r}")


# ---------------------------------------------------------------------------
# build + load

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources_digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, all started
    together) and link them into ``_build/libraft_tpu_torch_<hash>.so``.
    Returns the library path; an up-to-date library is not rebuilt."""
    out = BUILD_DIR / f"libraft_tpu_torch_{_sources_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{src.stem}_{os.getpid()}.o" for src in srcs]

    def compile_one(src, obj):
        """One source's nvcc run and its own wall seconds (the sources
        compile side by side, one thread waiting on each)."""
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(srcs))) as pool:
        done = list(pool.map(compile_one, srcs, objs))
    from raft_tpu_torch.obs import device_events

    failed = []
    for src, (proc, seconds) in zip(srcs, done):
        device_events.record("backend_compile", seconds=seconds)
        if verbose and proc.stdout:
            print(f"[nvcc {src.name}]\n{proc.stdout}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{proc.stdout}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float
_SIGNATURES = {
    "rt_select_k": [_P, _P, _L] + [_I] * 6 + [_P] * 3,
    # q, x, |x|^2, (n_q, n, d, k, ip_mode, splits, cap), scratch (values,
    # ids, counts), outputs and stream
    "rt_fused_knn": [_P, _P, _P] + [_I] * 7 + [_P] * 6,
    # probe-major: 6 arrays, (B, G, cap, d, kk, metric), then bf16_compute
    # (float legs) or scan_scale (int8), the filter words (null: unfiltered)
    # and cap_w, the page table (null: monolithic lists) and page_rows, the
    # candidate workspace past kk = 128 (values, ids: null below) and its
    # entries a row, then outputs and stream
    **{f"rt_ivf_scan_probe_major{leg}": [_P] * 6 + [_I] * 6 + [_F if leg == "_int8" else _I]
       + [_P, _I] * 2 + [_P, _P, _I] + [_P] * 3
       for leg in ("", "_bf16", "_int8", "_u8", "_s8")},
    # query-major: 6 arrays, (Q, P, cap, d, kk, metric, splits), then
    # bf16_compute or scan_scale, the filter words and query_fid (null: none),
    # n_lists and cap_w, the page table and page_rows, then parts, outputs
    # and stream
    "rt_ivf_scan_query_major": [_P] * 6 + [_I] * 8 + [_P, _P, _I, _I, _P, _I] + [_P] * 5,
    "rt_ivf_scan_query_major_bf16": [_P] * 6 + [_I] * 8 + [_P, _P, _I, _I, _P, _I] + [_P] * 5,
    "rt_ivf_scan_query_major_int8": ([_P] * 6 + [_I] * 7 + [_F] + [_P, _P, _I, _I, _P, _I]
                                     + [_P] * 5),
    "rt_ivf_scan_query_major_u8": [_P] * 6 + [_I] * 8 + [_P, _P, _I, _I, _P, _I] + [_P] * 5,
    "rt_ivf_scan_query_major_s8": [_P] * 6 + [_I] * 8 + [_P, _P, _I, _I, _P, _I] + [_P] * 5,
    # dataset (or page pool), bf16 flag, graph, queries, parents, buf_d,
    # buf_i, explored, (tile, d, deg, width, itopk, ip_mode), the page table
    # (null: dense) and page_rows, outputs and stream
    "rt_cagra_hop": [_P, _I] + [_P] * 6 + [_I] * 6 + [_P, _I] + [_P] * 4,
    # as rt_cagra_hop without the parents, then steps; outputs, the live
    # parents and fetched rows of a query's walk, and stream
    "rt_cagra_traverse": [_P, _I] + [_P] * 5 + [_I] * 7 + [_P, _I] + [_P] * 6,
    # x, centers, center norms, (n, n_centers, d, centers a part), part
    # pairs (null: one part), outputs and stream
    "rt_fused_argmin": [_P] * 3 + [_I] * 4 + [_P] * 5,
    # indptr, indices, data, x, (n_rows, n_cols, slots of indices), the plan
    # (scratch), output and stream
    "rt_csr_spmm": [_P] * 4 + [_I] * 3 + [_P] * 3,
}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from raft_tpu_torch.obs import device_events

            built = (BUILD_DIR / f"libraft_tpu_torch_{_sources_digest()}.so").exists()
            lib = ctypes.CDLL(str(build()))
            device_events.record("cache_hit" if built else "cache_miss")
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, code: int) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        msg = library().rt_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {code})")


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def grid_splits(blocks: int, max_splits: int, device: torch.device,
                per_sm: int = 4) -> int:
    """Parts to cut each block's work into (each part one more block, their
    lists merged after) so that a small batch still gives the card about
    ``per_sm`` blocks per SM."""
    want = -(-per_sm * sm_count(device.index or 0) // max(blocks, 1))
    return max(1, min(max_splits, want))


@functools.lru_cache(maxsize=1024)
def wave_splits(blocks: int, max_splits: int, slots: int, tiles: int = 0) -> int:
    """Parts to cut each of ``blocks`` blocks' work into (each part one
    more block) on a card that runs ``slots`` blocks at once: the fewest
    whose time (whole waves of blocks, each doing 1 / splits of a block's
    work: a wave begun for a few blocks costs a full one) is within 5 % of
    the least.  Each part keeps its own partial result, so fewer parts
    merge less.  ``tiles``: the work is that many tiles, cut into
    contiguous parts of ceil(tiles / s) tiles, so only the counts
    ceil(tiles / ceil(tiles / s)) occur."""
    limit = max(1, min(max_splits, 4 * -(-slots // blocks)))
    counts = {s if not tiles else -(-tiles // -(-tiles // s)) for s in range(1, limit + 1)}
    time = {s: -(-blocks * s // slots) / s for s in counts}
    best = min(time.values())
    return min(s for s, t in time.items() if t <= 1.05 * best)


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor a kernel reads must be a contiguous CUDA tensor on one
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


# raft_tpu's public names for the kernels (raft_tpu.kernels)
from raft_tpu_torch.kernels.fused_argmin import fused_l2_argmin  # noqa: E402
from raft_tpu_torch.kernels.fused_knn import fused_l2_topk  # noqa: E402
from raft_tpu_torch.kernels.ivf_scan import ivf_scan_probe_major  # noqa: E402
from raft_tpu_torch.kernels.cagra_traverse import cagra_fused_hop  # noqa: E402
