"""Build and load the port's CUDA kernels.

``nvcc`` compiles every source under ``repro_torch/csrc/`` for ``sm_90a``
(one process per source, all started together) and links them into one
shared library with a plain C interface, loaded with ``ctypes``.  That
takes seconds, against minutes for an extension that includes PyTorch's
headers.  The library lands in ``<repo>/build/repro_torch/`` under a name
keyed by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused.  Processes that start together (the
multi-process federation's, one per collaborator) build it once: the
first takes a file lock beside the library and builds, the others wait
on the lock and load what it built.

Nothing here runs at import: the first call to :func:`library` builds.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("tree_hist.cu", "boost_update.cu", "vote_argmax.cu", "flash_attention.cu",
           "flash_attention_sm90.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FLASH = [  # q, k, v, o, strides[12], B, H, Hkv, S, T, D, causal, window, scale, softcap, stream
    _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
_SIGNATURES = {  # every extern "C" function of the sources: (restype, argtypes)
    # bin_idx, leaf, wy, out, H, n, d, L, B1, K, dblk, cs, threads, stream
    "repro_tree_hist": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    # L, B1, K, dblk, cs, threads, &clusters
    "repro_tree_hist_max_clusters": (_I, [_I, _I, _I, _I, _I, _I, _P]),
    # preds, y, w, out, C, H, n, cs, rows per CTA, stream
    "repro_weighted_errors": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # w, mis, mask, alpha, out, N, cs, threads, stream
    "repro_weight_update": (_I, [_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P]),
    # w, mis, mask, alpha, out, N, blocks, threads, stream
    "repro_weight_update_product": (_I, [_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P]),
    # preds, alpha, out, T, n, K, classes per thread, threads, stream
    "repro_vote_argmax": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "repro_flash_attention_f32": (_I, _FLASH),
    "repro_flash_attention_bf16": (_I, _FLASH),
    # B, H, Hkv, S, T, D, causal, window, plan[3]
    "repro_flash_attention_f32_plan": (_I, [_I, _I, _I, _I, _I, _I, _I, _I, _P]),
    # B, H, Hkv, S, T, D, causal, window, plan[cap], cap
    "repro_flash_attention_bf16_plan": (_I, [_I, _I, _I, _I, _I, _I, _I, _I, _P, _I]),
    "repro_cuda_error_string": (ctypes.c_char_p, [_I]),
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build (None: reused)
build_log = ""  # nvcc's output (ptxas register / shared-memory report)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"


def _build(target: Path) -> None:
    global build_seconds, build_log
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, failed = [], []
        for cmd, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / target.name
        link = [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{' '.join(link)}\n{res.stdout}{res.stderr}")
        os.replace(tmp_lib, target)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0


def ensure_built(target: Path) -> None:
    """Build ``target`` unless it exists, under an exclusive lock on a file
    in ``BUILD_DIR``: of several processes at first use, one builds and
    the others find the library when the lock comes to them."""
    if target.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not target.exists():
            _build(target)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        target = library_path()
        ensure_built(target)
        lib = ctypes.CDLL(str(target))
        for fn, (restype, argtypes) in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: cudaError {rc} ({msg})")


def count(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel: in ``wrapper.launches``, or,
    when the call is captured into a CUDA graph (which launches nothing
    until it is replayed), in ``wrapper.captures``.  A graph's replays add
    their launches themselves (``ops.count_replay``)."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        wrapper.captures += 1
    else:
        wrapper.launches += 1
