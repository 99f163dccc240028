"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources in ``camkifu_tpu_torch/csrc`` are compiled for Hopper
(``sm_90a``), one nvcc process per source, all started together, and
linked into one shared library with a plain C interface, under
``build/camkifu_kernels/`` at the root of the checkout. The build runs at
the first kernel call of a process, and the library's name carries a hash
of the sources and flags, so an edited source rebuilds and an unchanged one
is loaded as it is. Nothing here runs at import time: machines without
``nvcc`` import the package and use the plain versions on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
SOURCES = ("warp.cu", "edge.cu", "hough.cu", "hysteresis.cu",
           "pcg_normal.cu", "vote_scan.cu")
HEADERS = ("common.cuh", "ziggurat_tables.cuh")
BUILD_DIR = _PKG.parent / "build" / "camkifu_kernels"

#: ``--fmad=false`` keeps every product and sum rounding on its own, as
#: the plain PyTorch versions round, so kernel and reference agree to the
#: last bits wherever the order of the terms is the same. ``-Xptxas -v``
#: reports registers, shared memory and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_U64 = ctypes.c_uint64
_SIGNATURES = {
    "camkifu_warp": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "camkifu_warp_lens": [_P, _P, _I, _P, _I, _F, _F, _F, _F, _F, _P, _I,
                          _I, _I, _I, _I, _I, _F, _P],
    "camkifu_edge": [_P, _P, _P, _I, _I, _I, _I, _I, ctypes.POINTER(_F),
                     _P],
    "camkifu_edge_scratch": [_I, _I],
    "camkifu_edge_taps": [],
    "camkifu_edge_strip": [_I],
    "camkifu_hysteresis": [_P, _P, _I, _I, _I, _P, _P, _F, _F, _I, _P],
    "camkifu_hysteresis_adaptive": [_P, _P, _I, _I, _I, _F, _F, _F, _I,
                                    _P],
    "camkifu_hysteresis_smem": [_I, _I, _I],
    "camkifu_hysteresis_lerp": [_P, _P, _P, _P, _I, _I, _P],
    "camkifu_hough": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                      _F, _P],
    "camkifu_pcg_normal": [_P, _P, _I, _U64, _U64, _U64, _U64, _I, _D, _F,
                           _F, _P, _P],
    "camkifu_pcg_normal_scratch": [_I],
    "camkifu_vote_scan": [ctypes.POINTER(_P), ctypes.POINTER(_F), _I, _I, _I,
                          _I, _I, _P],
    "camkifu_vote_scan_threads": [],
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libcamkifu_kernels_{source_hash()}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless a library of the same sources exists.

    Returns (library path, seconds spent compiling and linking — 0 when it
    was already built, the compiler's log).
    """
    so = library_path()
    log = so.with_suffix(".log")
    if so.exists():
        return so, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src}.o" for src in SOURCES]
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        outs = [(src, proc.communicate()[0], proc.returncode)
                for src, proc in zip(SOURCES, procs)]
        text = "".join(out for _, out, _ in outs)
        failed = [f"{src} (code {code})" for src, _, code in outs if code]
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True, check=False)
            text += link.stdout + link.stderr
            if link.returncode:
                failed.append(f"link (code {link.returncode})")
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{text}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log.write_text(text)
    os.replace(tmp, so)
    return so, seconds, text


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        loaded = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        loaded.camkifu_error_string.argtypes = [ctypes.c_int]
        loaded.camkifu_error_string.restype = ctypes.c_char_p
        _lib = loaded
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a kernel's launch returned a CUDA error."""
    if code:
        msg = lib().camkifu_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
