"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source (one process per file, all started
together) and links them into a shared library with a plain C interface,
which :mod:`ctypes` loads. The build happens at first use, into
``build/repro_torch/<hash>/`` at the root of the checkout (or beside the
package when it is installed), keyed by a hash of the sources and flags, so
a fresh checkout builds once and later processes reuse the library. A
failed build raises; nothing falls back to the plain PyTorch versions.

:func:`check_cuda_tensor` and :func:`launch` are what every kernel wrapper
(``kernels/*/ops.py``) uses to validate its arguments and call its entry
point on the current stream.

A wrapper given **fake** tensors (:func:`is_fake`: shapes and dtypes
without storage, under ``torch._subclasses.FakeTensorMode``, as the dry
run traces a step) on the card (:func:`on_card`) checks them as it would
real ones and allocates its outputs, but reads no data pointer and
launches nothing: it hands its
kernel's name and :class:`KernelCost` (the FLOPs and HBM bytes of the
work the kernel would do, from the cost function beside it in
``ops.py``) to :func:`record`, which passes them to the open
:func:`recording` blocks. A fake call counts no launch. A real CUDA
tensor still goes to the kernel or raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Iterator, List, NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["KernelCost", "NVCC_FLAGS", "build_dir", "check_cuda_tensor",
           "find_nvcc", "is_fake", "launch", "load_library", "on_card",
           "record", "recording"]

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
_CSRC = _PKG / "csrc"
_LIB_NAME = "librepro_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOID_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_float)
#: C signature of every exported function: (argtypes, restype).
_SIGNATURES = {
    "qos_matrix_launch": ([_VOID_P] * 10 + [_I64, _I64, _F32, _I32, _VOID_P],
                          _I32),
    "qos_candidates_launch": ([_VOID_P] * 9 + [_I64, _I32, _F32, _I32,
                                              _VOID_P], _I32),
    # (u_service, u_alpha, u_delta, u_share_k, u_share_w, table, sm_acc,
    #  sm_k, sm_w, cand_idx, cand_q, U, S, M, P, k, delta_max, device,
    #  stream)
    "topk_candidates_launch": ([_VOID_P] * 11 + [_I64] + [_I32] * 4
                               + [_F32, _I32, _VOID_P], _I32),
    "greedy_argmax_launch": ([_VOID_P] * 4 + [_I32, _I32, _I32, _VOID_P],
                             _I32),
    # (q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, hd, is_bf16, causal, window,
    #  softcap, device, stream)
    "flash_attention_launch": ([_VOID_P] * 5 + [_I32] * 9 + [_F32, _I32,
                                                            _VOID_P], _I32),
    # (q, k, v, do, lse, dsum, dq, B, Sq, Skv, Hq, Hkv, hd, is_bf16, causal,
    #  window, softcap, device, stream)
    "flash_attention_dq_launch": ([_VOID_P] * 7 + [_I32] * 9 + [_F32, _I32,
                                                               _VOID_P],
                                  _I32),
    # (q, k, v, do, lse, dsum, dk, dv, B, ..., window, softcap, device,
    #  stream)
    "flash_attention_dkv_launch": ([_VOID_P] * 8 + [_I32] * 9 + [_F32, _I32,
                                                                _VOID_P],
                                   _I32),
    # (q, k_cache, v_cache, kv_len, out, lse, B, Sc, Hkv, G, hd, is_bf16,
    #  window, ring, splits, slot0, sc_total, softcap, device, stream)
    "gqa_decode_launch": ([_VOID_P] * 6 + [_I32] * 11 + [_F32, _I32,
                                                       _VOID_P], _I32),
    # (x, dtA, b, c, initial_state, y, state, cb, chunk_states, entering,
    #  decay, B, L, H, P, N, chunk, device, stream)
    "ssd_scan_launch": ([_VOID_P] * 11 + [_I32] * 7 + [_VOID_P], _I32),
    # (x, dtA, b, c, dy, dfinal, entering, decay, dx, ddtA, db, dc, dinit,
    #  cb, dcb, dchunk, acum, da_off, B, L, H, P, N, chunk, device, stream)
    "ssd_scan_bwd_launch": ([_VOID_P] * 18 + [_I32] * 7 + [_VOID_P], _I32),
    "cuda_error_string": ([_I32], ctypes.c_char_p),
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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; wait for every one, then raise if any
    failed. Returns their output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [proc.communicate() for proc in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}\n{err}")
    return "".join(o + e for o, e in outs)


def _compile(sources: list[Path], out: Path) -> str:
    """Compile every ``.cu`` source with its own nvcc, all at once, link
    the objects into a temporary library and move it into place
    atomically, so concurrent first uses never load a half-written
    library. Returns nvcc's output (ptxas register and spill report
    included). ``tools/kernel_build_times.py`` times this against one nvcc
    call over all sources; its readings on an H100 machine are in
    PERF.md."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp) / f"{s.stem}.o") for s in sources
                if s.suffix == ".cu"]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for obj, src in zip(objs, (s for s in sources
                                                   if s.suffix == ".cu"))])
        lib = str(Path(tmp) / out.name)
        log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib,
                          *objs]])
        os.replace(lib, out)
    return log


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


class KernelCost(NamedTuple):
    """The work of one kernel call: operations (2 per multiply-add) and
    the bytes it must move to and from HBM (each input read once, each
    output written once)."""
    flops: float
    bytes: float


_RECORDERS: List[Callable[[str, KernelCost], None]] = []


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (a shape and dtype without storage:
    ``FakeTensorMode``'s)."""
    return isinstance(t, FakeTensor)


def on_card(t: torch.Tensor) -> bool:
    """Whether the kernels take ``t``: a CUDA tensor, or a fake tensor on
    the ``meta`` device, which stands in for the card where the dry run
    traces on a PyTorch built without CUDA (there a fake CUDA tensor can
    be made but not indexed, copied or differentiated: those need CUDA's
    device guard)."""
    return t.is_cuda or (t.device.type == "meta" and is_fake(t))


def record(name: str, cost: KernelCost) -> None:
    """A kernel call on fake tensors: hand it to every open
    :func:`recording`."""
    for fn in _RECORDERS:
        fn(name, cost)


@contextlib.contextmanager
def recording(fn: Callable[[str, KernelCost], None]) -> Iterator:
    """Within the block, ``fn(name, cost)`` sees every kernel call made on
    fake tensors."""
    _RECORDERS.append(fn)
    try:
        yield fn
    finally:
        _RECORDERS.remove(fn)


def check_cuda_tensor(name: str, t, dtype, shape: tuple, device,
                      align: int = 1) -> int:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    the CUDA ``device`` whose data starts on an ``align``-byte boundary (16
    for kernels that read it with 16-byte loads); return its data
    pointer (0 for a fake tensor, which has none)."""
    if not isinstance(t, torch.Tensor) or t.device != device \
            or not on_card(t):
        raise ValueError(f"{name}: expected a tensor on a CUDA device "
                         f"({device}), got {getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if is_fake(t):
        return 0
    if t.data_ptr() % align:
        raise ValueError(f"{name}: expected a {align}-byte aligned tensor")
    return t.data_ptr()


def launch(fn: str, *args, device) -> None:
    """Call the kernel entry point ``fn`` with ``args`` plus the device
    index and PyTorch's current stream; raise if it reports a CUDA error."""
    lib, _ = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(*args, device.index, stream)
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{fn}: CUDA error {err}: {msg}")
