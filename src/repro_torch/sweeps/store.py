"""Append-only on-disk result store for resumable sweeps.

Layout under the store root::

    spec.json             # the spec that owns this store (informational)
    manifest.jsonl        # one line per completed chunk (append-only)
    manifest.lock         # advisory flock serializing manifest appends
    shards/NNNNNN_<h>.npz # values/times/keys (+ per-item metric_*) arrays

Each manifest line records the work-item keys a shard covers, so resume is
*item*-granular: chunk boundaries may change between runs (different device
count, different ``--chunk-size``) and previously computed items are still
skipped. A shard's ``.npz`` is written to a tempfile and atomically renamed
into place **before** its manifest line lands; a crash between the two
leaves an orphan shard file that the next run simply ignores and recomputes
— the manifest is always the source of truth, and no line in it ever
dangles for longer than one ``load`` (lines whose shard file is missing are
dropped defensively).

Concurrent writers (any two processes pointed at the same store) are
safe: every append takes the advisory ``manifest.lock`` (``flock`` —
released by the kernel if the holder dies), re-reads the manifest to pick
up lines other writers landed meanwhile, and publishes the new manifest
via fsync'd tempfile-``os.replace`` — so a writer killed at *any*
instruction can never leave a torn line that poisons resume, and no
writer ever clobbers another's lines.

Store schema v3 adds optional **per-item metric arrays**: ``add_chunk``
accepts a ``metrics`` mapping of named per-row arrays (the serving path
persists ``submitted``/``served``/``misses``/``latency``/``accuracy`` per
tick), saved as ``metric_<name>`` inside the shard npz and read back via
:meth:`SweepStore.metrics`.

The layout and every array are the reference's (:mod:`repro.sweeps.store`),
so each package's store reads a store the other wrote.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, \
    Sequence

import numpy as np

from repro_torch import obs

try:                      # POSIX advisory locks; auto-released on death
    import fcntl
except ImportError:       # pragma: no cover - non-POSIX fallback (no lock)
    fcntl = None

__all__ = ["SweepStore", "atomic_write"]

_METRIC_PREFIX = "metric_"


def _fsync_dir(path: Path) -> None:
    """Flush a directory entry (rename durability); best-effort."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:       # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    except OSError:       # pragma: no cover
        pass
    finally:
        os.close(fd)


def atomic_write(path: "os.PathLike | str", payload: bytes) -> None:
    """Publish ``payload`` at ``path`` via fsync'd tempfile + rename.

    The store's crash-publication primitive: a writer killed at any
    instruction leaves either the old file or the new one, never a torn
    hybrid (the stray ``.tmp`` is ignored by every reader).
    """
    path = Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    _fsync_dir(path.parent)


class SweepStore:
    """Item-keyed, append-only npz/jsonl result store."""

    def __init__(self, root: os.PathLike | str):
        self.root = Path(root)
        self.shard_dir = self.root / "shards"
        self.manifest_path = self.root / "manifest.jsonl"
        self.lock_path = self.root / "manifest.lock"
        self.shard_dir.mkdir(parents=True, exist_ok=True)
        #: item key -> (shard file name, row index)
        self._index: Dict[str, tuple] = {}
        #: item key -> manifest meta of its chunk
        self._meta: Dict[str, Dict[str, Any]] = {}
        #: parsed manifest records (shard file present), in append order
        self._records: List[Dict[str, Any]] = []
        self._n_lines = 0
        self._npz_cache: Dict[str, Dict[str, np.ndarray]] = {}
        #: (size, mtime_ns) of the manifest as this handle last wrote it —
        #: lets the single-writer fast path skip the under-lock reparse
        self._publish_stat: Optional[tuple] = None
        self._load()

    # ------------------------------------------------------------------
    def _ingest_line(self, line: str) -> None:
        line = line.strip()
        if not line:
            return
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            return  # torn final line from a pre-v3 killed writer
        self._n_lines += 1
        shard = rec.get("shard", "")
        if not (self.shard_dir / shard).exists():
            return  # orphaned manifest entry; items will recompute
        self._records.append(rec)
        for row, key in enumerate(rec.get("keys", [])):
            self._index[key] = (shard, row)
            self._meta[key] = rec.get("meta", {})

    def _load(self) -> None:
        if not self.manifest_path.exists():
            return
        for line in self.manifest_path.read_text().splitlines():
            self._ingest_line(line)

    def _reload(self) -> None:
        """Drop state and re-read the manifest (used under the lock to pick
        up lines concurrent writers appended since our last read)."""
        self._index.clear()
        self._meta.clear()
        self._records.clear()
        self._n_lines = 0
        self._load()

    @contextlib.contextmanager
    def _locked(self) -> Iterator[None]:
        """Advisory exclusive lock over manifest mutation. ``flock`` is
        released by the kernel when the holder dies, so a killed writer can
        never wedge the store."""
        with open(self.lock_path, "a+b") as lf:
            if fcntl is not None:
                fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                if fcntl is not None:
                    fcntl.flock(lf.fileno(), fcntl.LOCK_UN)

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._index)

    def completed(self, keys: Iterable[str]) -> List[str]:
        return [k for k in keys if k in self._index]

    def keys(self) -> List[str]:
        """Every completed item key, in manifest (insertion) order —
        lets store consumers walk a possibly-partial store without
        reconstructing its spec."""
        return list(self._index)

    def chunks(self) -> List[Dict[str, Any]]:
        """The parsed manifest records whose shard file exists, in append
        order (a chunk-granular walk)."""
        return [dict(rec) for rec in self._records]

    # ------------------------------------------------------------------
    def write_spec(self, spec_json: Mapping[str, Any]) -> None:
        path = self.root / "spec.json"
        if not path.exists():
            path.write_text(json.dumps(spec_json, indent=1))

    def _manifest_stat(self) -> Optional[tuple]:
        try:
            st = self.manifest_path.stat()
        except OSError:
            return None
        return (st.st_size, st.st_mtime_ns)

    def add_chunk(self, keys: Sequence[str], values: np.ndarray,
                  times: np.ndarray,
                  meta: Optional[Mapping[str, Any]] = None,
                  metrics: Optional[Mapping[str, Any]] = None) -> str:
        """Persist one evaluated chunk; returns the shard file name.

        ``metrics`` optionally carries named per-row float arrays (same
        length as ``keys``) stored alongside ``values`` in the shard npz —
        the schema-v3 per-item serving metrics.

        Durability over append speed: the manifest is *republished whole*
        (atomic rename — no torn line is ever possible), so each append
        writes O(chunks-so-far) bytes. Manifest lines are per-*chunk*
        (coarse — a chunk is seconds of compute), and the single-writer
        fast path below skips the under-lock reparse when nobody else
        touched the file, so the rewrite stays noise next to evaluation.
        """
        assert len(keys) == len(values) == len(times)
        with obs.span("store.add_chunk", rows=len(keys)):
            return self._add_chunk(keys, values, times, meta, metrics)

    def _add_chunk(self, keys, values, times, meta, metrics) -> str:
        arrays = {"values": np.asarray(values, np.float64),
                  "times": np.asarray(times, np.float64),
                  "keys": np.asarray(list(keys))}
        metric_names: List[str] = []
        for name, arr in sorted((metrics or {}).items()):
            arr = np.asarray(arr, np.float64)
            assert arr.shape == (len(keys),), \
                f"metric {name!r} must be one value per key"
            arrays[_METRIC_PREFIX + str(name)] = arr
            metric_names.append(str(name))

        with self._locked():
            # pick up chunks concurrent writers appended since our last
            # read — both for shard-name allocation and so the rewritten
            # manifest below keeps their lines. Fast path: if the manifest
            # is exactly as this handle last published it, our in-memory
            # state IS the file and the reparse is skipped.
            if self._manifest_stat() != self._publish_stat or \
                    self._publish_stat is None:
                self._reload()
            name = f"{self._n_lines:06d}_{keys[0][:8]}.npz"
            while (self.shard_dir / name).exists():
                self._n_lines += 1
                name = f"{self._n_lines:06d}_{keys[0][:8]}.npz"
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            atomic_write(self.shard_dir / name, buf.getvalue())

            rec = {"shard": name, "keys": list(keys),
                   "meta": dict(meta or {})}
            if metric_names:
                rec["metrics"] = metric_names
            # full-content republish via tempfile + atomic rename: a killed
            # writer can never leave a torn line, and valid lines (ours and
            # other writers') survive verbatim
            lines = [json.dumps(r, separators=(",", ":"))
                     for r in self._records] + \
                    [json.dumps(rec, separators=(",", ":"))]
            atomic_write(self.manifest_path,
                         ("\n".join(lines) + "\n").encode())
            self._publish_stat = self._manifest_stat()
            self._records.append(rec)
            self._n_lines += 1
            for row, key in enumerate(keys):
                self._index[key] = (name, row)
                self._meta[key] = rec["meta"]
        return name

    # ------------------------------------------------------------------
    def _shard(self, name: str) -> Dict[str, np.ndarray]:
        if name not in self._npz_cache:
            with np.load(self.shard_dir / name) as z:
                self._npz_cache[name] = {k: z[k] for k in z.files
                                         if k != "keys"}
        return self._npz_cache[name]

    def value(self, key: str) -> float:
        shard, row = self._index[key]
        return float(self._shard(shard)["values"][row])

    def time(self, key: str) -> float:
        shard, row = self._index[key]
        return float(self._shard(shard)["times"][row])

    def meta(self, key: str) -> Dict[str, Any]:
        return dict(self._meta.get(key, {}))

    def metrics(self, key: str) -> Dict[str, float]:
        """The item's named per-row metrics (schema v3); ``{}`` when its
        chunk predates metric persistence."""
        shard, row = self._index[key]
        return {name[len(_METRIC_PREFIX):]: float(arr[row])
                for name, arr in self._shard(shard).items()
                if name.startswith(_METRIC_PREFIX)}

    def chunk_data(self, shard: str) -> Dict[str, np.ndarray]:
        """All row arrays of one shard (``values``/``times``/``metric_*``)
        — the bulk read of one chunk."""
        return {name: arr.copy() for name, arr in self._shard(shard).items()}
