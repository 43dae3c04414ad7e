"""Build, load and count the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/<source>.cu`` has a plain C interface and compiles on its own::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o csrc/build/<source>-<hash>.so csrc/<source>.cu

The library is named after a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited source builds anew and a stale library is never
loaded. Nothing is built at import time: a
wrapper builds its library the first time it runs on a CUDA tensor, and
``build()`` starts several nvcc processes at once. The libraries are loaded
with ctypes; every entry returns ``cudaGetLastError()`` and the wrappers raise
on anything but 0.

Each wrapper counts one launch (``count_launch``) exactly where it launches
its kernel, so a run can show in ``LAUNCHES`` which kernels its main path
went through (the WKV kernels' precision="bf16" instances count under
``<name>_bf16``). A wrapper called while its thread captures a CUDA graph
launches nothing: its counts go to that capture's own tally
(``record_launches``), never to ``LAUNCHES``, so other threads' launches
meanwhile are counted as they happen; each replay of the graph adds the
tally (``add_launches``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("wkv7_step", "wkv7_chunk", "wkv7_batch", "mm8_a8", "mm8_w16", "penalty_tail",
           "sample_exact")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# launch counts by kernel name; plain integers, reset with reset_launches(),
# changed under _count_lock
LAUNCHES: Dict[str, int] = {"wkv7_step_fused": 0, "wkv7_chunk_fused": 0, "wkv7_batch": 0,
                            "wkv7_step_fused_bf16": 0, "wkv7_chunk_fused_bf16": 0,
                            "wkv7_batch_bf16": 0, "mm8_a8_quant_rows": 0, "mm8_a8_gemm": 0,
                            "mm8_w16_gemm": 0, "penalty_tail": 0, "sample_exact_rows": 0}

_lock = threading.Lock()
_count_lock = threading.Lock()
_capturing = threading.local()  # .tally: the counts of this thread's capture
_libs: Dict[str, ctypes.CDLL] = {}

P = ctypes.c_void_p
I = ctypes.c_int


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """One launch of kernel `name`: into LAUNCHES, or into the tally of the
    graph this thread is capturing."""
    tally = getattr(_capturing, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
        return
    with _count_lock:
        LAUNCHES[name] += 1


def record_launches(fn: Callable[[], Any]) -> Tuple[Any, Dict[str, int]]:
    """Run fn (a graph capture) on this thread and return (its result, the
    launches its wrappers counted), none of them in LAUNCHES: a capture
    runs no kernel."""
    outer = getattr(_capturing, "tally", None)
    _capturing.tally = tally = {}
    try:
        out = fn()
    finally:
        _capturing.tally = outer
    return out, tally


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches of one replay of a captured graph."""
    with _count_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                           "the CUDA kernels cannot be built")
    return path


def library_path(source: str) -> Path:
    text = (CSRC / f"{source}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{source}-{digest}.so"


def build(sources: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, all nvcc processes at
    once. Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{src}.cu")]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {src}.cu (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {src: library_path(src) for src in sources}


def library(source: str, signatures: Dict[str, Iterable]) -> ctypes.CDLL:
    """The loaded library of ``source``, built on first use. ``signatures``
    maps each entry point to its ctypes argument types (restype is int)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build((source,))[source]))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, f"{source}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


def check(lib: ctypes.CDLL, source: str, fn: str, code: int) -> None:
    if code != 0:
        msg = getattr(lib, f"{source}_error_string")(code).decode()
        raise RuntimeError(f"{fn}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} not supported by the kernel "
                        f"(float32 or bfloat16)")
    return code


def require(t: torch.Tensor, what: str, *, dtype=None, shape=None,
            device=None, align: int = 1) -> None:
    """Raise unless t is a contiguous tensor of the given dtype, shape and
    device, whose data starts on an `align`-byte boundary (the kernels take
    raw pointers; 16-byte vector loads need align=16)."""
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{what}: expected dtype {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{what}: data must start on a {align}-byte boundary")
