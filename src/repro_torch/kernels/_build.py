"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/repro_torch_kernels/`` at the root of the checkout, on first use.
The library's file name carries a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is reused.  Libraries are
loaded with :mod:`ctypes`; every pointer and the stream pass as
``c_void_p`` and every launch function returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module of
the port on machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("saga_correct", "weiszfeld", "robust_stats", "topology",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches per wrapper: each wrapper adds one right after a launch
# that returned no error, and nowhere else (read via kernels.ops).
LAUNCHES = {"saga_correct": 0, "partial_sqdist": 0, "weighted_sum": 0,
            "coordinate_median": 0, "trimmed_mean": 0,
            "partial_sqdist_segments": 0, "masked_neighbor_reduce": 0,
            "flash_attention": 0}

# The message dtypes the kernels take, and the suffix of each launch
# function's name for it (``saga_correct_f32``, ``saga_correct_bf16``, ...).
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Launches of the bf16 routes, per kernel and per "<kernel> <route>" of the
# kernels that count routes (K1, K2, K7); a launch counts in LAUNCHES too.
BF16_LAUNCHES: dict[str, int] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``
    (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of repro_torch are built on the machine with the card")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    for part in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, with one
    ``nvcc`` process per source, all started together.  Returns each
    source's compiler log (``-Xptxas -v`` register/spill summary).  Raises
    if any build fails, after every process has ended."""
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if todo:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, out in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    logs = {}
    for name in names:
        log = library_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, declaring
    ``argtypes`` for each function in ``signatures`` (all return int)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function reported a CUDA error."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_dtype(what: str, t, name: str = "z") -> None:
    """Raise unless ``t`` is float32 or bfloat16 (the wires' buffers)."""
    if t.dtype not in SUFFIX:
        raise TypeError(f"{what}: {name} must be float32 or bfloat16, got "
                        f"{t.dtype}")


def count(name: str, dtype, route: str | None = None) -> None:
    """Count one launch of kernel ``name`` (and its bf16 route)."""
    LAUNCHES[name] += 1
    if dtype == torch.bfloat16:
        for key in (name,) if route is None else (name, f"{name} {route}"):
            BF16_LAUNCHES[key] = BF16_LAUNCHES.get(key, 0) + 1
