"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles the sources into a shared library with a plain C
interface, which :mod:`ctypes` loads. The build happens at first use, into
``build/repro_torch/<hash>/`` at the root of the checkout (or beside the
package when it is installed), keyed by a hash of the sources and flags, so
a fresh checkout builds once and later processes reuse the library. A
failed build raises; nothing falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "find_nvcc", "load_library"]

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
_CSRC = _PKG / "csrc"
_LIB_NAME = "libqos_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOID_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_float)
#: C signature of every exported function: (argtypes, restype).
_SIGNATURES = {
    "qos_matrix_launch": ([_VOID_P] * 10 + [_I64, _I64, _F32, _I32, _VOID_P],
                          _I32),
    "qos_candidates_launch": ([_VOID_P] * 9 + [_I64, _I32, _F32, _I32,
                                              _VOID_P], _I32),
    "greedy_argmax_launch": ([_VOID_P] * 4 + [_I32, _I32, _I32, _VOID_P],
                             _I32),
    "qos_error_string": ([_I32], ctypes.c_char_p),
}


def _sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh",
                                                               ".h"))


def build_dir() -> Path:
    """``<checkout>/build/repro_torch`` for a source checkout (``src/``
    layout), else ``_build`` beside the installed package."""
    if _PKG.parent.name == "src":
        return _PKG.parent.parent / "build" / "repro_torch"
    return _PKG / "_build"


def find_nvcc() -> str:
    """``nvcc`` from PyTorch's ``CUDA_HOME``, then ``$CUDA_HOME``, then
    ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (CUDA_HOME, os.environ.get("CUDA_HOME")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in torch's CUDA_HOME, "
                           "$CUDA_HOME and PATH); the CUDA kernels cannot "
                           "be built")
    return found


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources: list[Path], out: Path) -> str:
    """Run nvcc into a temporary file and move it into place atomically,
    so concurrent first uses never load a half-written library. Returns
    nvcc's output (ptxas register and spill report included)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in sources if s.suffix == ".cu"]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> tuple[ctypes.CDLL, dict]:
    """Build (once per source hash) and load the kernel library.

    Returns ``(lib, info)``; ``info`` holds the library path, whether this
    call built it, the build seconds and nvcc's report.
    """
    sources = _sources()
    path = build_dir() / _digest(sources) / _LIB_NAME
    info = {"path": str(path), "built": False, "build_s": 0.0, "log": ""}
    if not path.is_file():
        t0 = time.perf_counter()
        info["log"] = _compile(sources, path)
        info["build_s"] = time.perf_counter() - t0
        info["built"] = True
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib, info
