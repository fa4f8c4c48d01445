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
  loaded at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
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
    "ivf_scan_query_major_bf16", "ivf_scan_query_major_int8",
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
    procs = []
    objs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}_{os.getpid()}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for src, proc in procs:
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {src.name}]\n{log}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
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
    "rt_select_k": [_P, _P, _L, _I, _I, _I, _I, _I, _P, _P, _P],
    "rt_fused_knn": [_P, _P, _P] + [_I] * 6 + [_P] * 5,
    # probe-major: 6 arrays, (B, G, cap, d, kk, metric), then bf16_compute
    # (float legs) or scan_scale (int8), then outputs and stream
    "rt_ivf_scan_probe_major": [_P] * 6 + [_I] * 7 + [_P] * 3,
    "rt_ivf_scan_probe_major_bf16": [_P] * 6 + [_I] * 7 + [_P] * 3,
    "rt_ivf_scan_probe_major_int8": [_P] * 6 + [_I] * 6 + [_F] + [_P] * 3,
    # query-major: 6 arrays, (Q, P, cap, d, kk, metric, splits), then
    # bf16_compute or scan_scale, then parts, outputs and stream
    "rt_ivf_scan_query_major": [_P] * 6 + [_I] * 8 + [_P] * 5,
    "rt_ivf_scan_query_major_bf16": [_P] * 6 + [_I] * 8 + [_P] * 5,
    "rt_ivf_scan_query_major_int8": [_P] * 6 + [_I] * 7 + [_F] + [_P] * 5,
}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
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
