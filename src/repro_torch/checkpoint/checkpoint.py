"""Fault-tolerant checkpoints: the port of ``repro.checkpoint``, with the
reference's on-disk layout (one step):

    <dir>/step_000000123.tmp-<nonce>/  — written here first
        manifest.json                  — step, treedef, time, and per leaf
                                         its file, shape, dtype, whether it
                                         is stored raw, and its sha256
        leaf_00000.npy …               — one .npy per leaf
    <dir>/step_000000123/              — atomic rename on completion

* **atomicity** — a crash mid-write never corrupts the latest checkpoint
  (tmp dir + rename; restore only considers finished dirs with a manifest);
* **integrity** — sha256 per leaf, verified on restore;
* **keep-last-k GC** and auto-resume from the newest finished step;
* **async save** — :class:`CheckpointManager` copies the leaves to the host
  on the caller's thread and writes them on a background thread.

Leaves are tensors, flattened in a fixed order: a NamedTuple
(``TrainState``, ``AdamWState``) by field, an ``nn.Module`` by
``named_parameters()``, a dict by sorted key (as JAX flattens dicts), a
list or tuple in order. bf16 leaves are stored as raw ``uint8`` bytes with
their logical dtype in the manifest, as the reference stores its
``ml_dtypes`` leaves, and are decoded with torch, so NumPy needs no bf16
type. Restoring into a tree that holds a module loads the module's
parameters in place.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint"]

#: Logical dtypes stored as raw bytes, as torch decodes them.
_RAW = {"bfloat16": torch.bfloat16}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree) -> Tuple[List[Any], str]:
    """``(leaves, treedef)``: the leaves in the fixed order and a string
    describing the structure (leaves as ``*``)."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if _is_namedtuple(node):
            return f"{type(node).__name__}(" + ", ".join(
                f"{f}={walk(getattr(node, f))}" for f in node._fields) + ")"
        if isinstance(node, nn.Module):
            params = list(node.named_parameters())
            leaves.extend(p for _, p in params)
            return f"{type(node).__name__}{{" + ", ".join(
                f"{n}: *" for n, _ in params) + "}"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, (list, tuple)):
            inner = ", ".join(walk(x) for x in node)
            return f"[{inner}]" if isinstance(node, list) else f"({inner})"
        if not isinstance(node, torch.Tensor):
            raise TypeError(f"checkpoint leaves must be tensors, got "
                            f"{type(node).__name__}")
        leaves.append(node)
        return "*"

    treedef = walk(tree)
    return leaves, treedef


def _unflatten(like, leaves):
    """``like``'s structure with the leaves of the iterator ``leaves``
    (modules loaded in place)."""
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, nn.Module):
        with torch.no_grad():
            for name, p in like.named_parameters():
                val = next(leaves)
                if tuple(val.shape) != tuple(p.shape):
                    raise ValueError(f"checkpoint leaf for {name} has shape "
                                     f"{tuple(val.shape)}, expected "
                                     f"{tuple(p.shape)}")
                p.copy_(val)
        return like
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves).to(like.device)


def _to_host(leaf: torch.Tensor) -> torch.Tensor:
    """A CPU copy of the leaf, so later in-place updates, on the device or
    on the CPU, do not reach it."""
    return leaf.detach().to("cpu", copy=True)


def _encode_leaf(t: torch.Tensor) -> Tuple[np.ndarray, str, list, bool]:
    """``(stored, dtype name, shape, raw_encoded)``: native dtypes as NumPy
    arrays; bf16 as its raw bytes (the reference's encoding)."""
    name = str(t.dtype).removeprefix("torch.")
    if name in _RAW:
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
        return raw, name, list(t.shape), True
    arr = t.numpy()
    return arr, arr.dtype.name, list(arr.shape), False


def _decode_leaf(raw: np.ndarray, dtype_name: str, shape,
                 encoded: bool) -> torch.Tensor:
    if not encoded:
        return torch.from_numpy(raw)
    return torch.from_numpy(raw.copy()).view(_RAW[dtype_name]).reshape(
        shape)


def _write(directory: Path, step: int, host_leaves, treedef: str,
           keep: int) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step:09d}.tmp-{os.urandom(4).hex()}"
    tmp.mkdir()
    manifest = {"step": step, "treedef": treedef, "time": time.time(),
                "leaves": []}
    for i, arr in enumerate(host_leaves):
        name = f"leaf_{i:05d}.npy"
        stored, dtype_name, shape, encoded = _encode_leaf(arr)
        with open(tmp / name, "wb") as f:
            np.save(f, stored)
        manifest["leaves"].append({
            "name": name, "shape": shape, "dtype": dtype_name,
            "raw_encoded": encoded,
            "sha256": hashlib.sha256(stored.tobytes()).hexdigest(),
        })
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    final = directory / f"step_{step:09d}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _gc(directory, keep)
    return final


def save_checkpoint(directory, step: int, tree, *, keep: int = 3) -> Path:
    """Blocking save. Returns the final checkpoint path."""
    leaves, treedef = _flatten(tree)
    return _write(Path(directory), step, [_to_host(x) for x in leaves],
                  treedef, keep)


def _gc(directory: Path, keep: int) -> None:
    steps = sorted(p for p in directory.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and ".tmp-" not in p.name)
    for p in steps[:-keep] if keep else []:
        shutil.rmtree(p, ignore_errors=True)
    # orphaned tmp dirs from crashes
    for p in directory.iterdir():
        if ".tmp-" in p.name and time.time() - p.stat().st_mtime > 3600:
            shutil.rmtree(p, ignore_errors=True)


def latest_step(directory) -> Optional[int]:
    """The newest finished step in ``directory`` (a ``step_*`` dir with a
    manifest, not a ``.tmp-`` one), or ``None``."""
    directory = Path(directory)
    if not directory.exists():
        return None
    best = None
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_") \
                and ".tmp-" not in p.name and (p / "manifest.json").exists():
            best = max(best if best is not None else -1,
                       int(p.name.split("_")[1]))
    return best


def restore_checkpoint(directory, step: int, tree_like, *,
                       verify: bool = True):
    """Restore step ``step`` into the structure of ``tree_like``: tensor
    leaves on their ``like``'s device, modules loaded in place. Raises
    :class:`IOError` on a checksum mismatch and :class:`ValueError` when
    the leaf count or a module's shapes differ."""
    path = Path(directory) / f"step_{step:09d}"
    manifest = json.loads((path / "manifest.json").read_text())
    leaves_like, _ = _flatten(tree_like)
    if len(manifest["leaves"]) != len(leaves_like):
        raise ValueError(f"leaf count mismatch: {len(manifest['leaves'])} "
                         f"in {path} vs {len(leaves_like)}")
    out = []
    for meta in manifest["leaves"]:
        arr = np.load(path / meta["name"])
        if verify and hashlib.sha256(arr.tobytes()).hexdigest() \
                != meta["sha256"]:
            raise IOError(f"checksum mismatch in {path / meta['name']}")
        out.append(_decode_leaf(arr, meta["dtype"], meta["shape"],
                                meta.get("raw_encoded", False)))
    return _unflatten(tree_like, iter(out))


class CheckpointManager:
    """Async keep-k manager with auto-resume."""

    def __init__(self, directory, *, keep: int = 3, every: int = 100):
        self.directory = Path(directory)
        self.keep = keep
        self.every = every
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def maybe_save(self, step: int, tree) -> bool:
        """At every ``every``-th step: copy the leaves to the host on this
        thread (the caller may update the tree right after), then write
        them on a background thread."""
        if step % self.every:
            return False
        self.wait()
        leaves, treedef = _flatten(tree)
        host = [_to_host(x) for x in leaves]

        def work():
            try:
                _write(self.directory, step, host, treedef, self.keep)
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        """Join the pending write; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, tree_like):
        """``(step, tree)`` of the newest finished checkpoint, or
        ``(None, None)``."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, tree_like)
