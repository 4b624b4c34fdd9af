"""Directory-backed lease queue — the fleet's shared work manifest (the
port of :mod:`repro.fleet.queue`; its files are the reference's byte for
byte).

The queue is three sibling directories on a filesystem every worker can
reach (one host's disk, or NFS/Lustre across hosts)::

    <fleet_root>/queue/
        tasks/NNNNNN_<h>.json   # claimable task documents
        leases/NNNNNN_<h>.json  # claimed tasks (doc + owner/ttl lease block)
        done/NNNNNN_<h>.json    # completed tasks

Every state transition is a single atomic ``os.rename`` on one file, so
exactly one worker wins any claim and no state is ever half-visible:

* **claim** — ``rename(tasks/T, leases/T)``: atomic, single winner; the
  winner then republishes the file with an embedded lease block (owner,
  ``claimed_at``, ``expires_at``) via ``O_EXCL`` tempfile + rename;
* **heartbeat** — the owner republishes the lease file with a fresh
  ``expires_at`` (tempfile + rename, atomic);
* **complete** — ``rename(leases/T, done/T)``;
* **requeue** (crash recovery) — anyone may ``rename(leases/T, tasks/T)``
  once the lease has expired: a worker SIGKILLed mid-chunk stops
  heartbeating, its lease runs out, and :meth:`LeaseQueue.reap` puts the
  task back for the next claimant.

The expiry/requeue race (a paused-but-alive worker loses its lease and a
second worker re-executes the chunk) is *safe by construction*: task
execution is deterministic, every worker appends to its own store, and
the coordinator's merge dedups by item hash and verifies duplicate values
bit-for-bit — a re-executed chunk is wasted work, never wrong data.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import socket
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.sweeps.store import atomic_write

__all__ = ["DEFAULT_TTL_S", "Task", "Lease", "LeaseQueue",
           "default_owner"]

#: Default lease time-to-live. A worker heartbeats at ``ttl / 3``, so the
#: TTL bounds how long a crashed worker's chunk stays stuck, not how long
#: a chunk may take.
DEFAULT_TTL_S = 60.0

_TASKS, _LEASES, _DONE = "tasks", "leases", "done"
_POISON_SUFFIX = ".poison"


def default_owner() -> str:
    """``<host>-<pid>`` — unique per live worker process."""
    return f"{socket.gethostname()}-{os.getpid()}"


@dataclasses.dataclass(frozen=True)
class Task:
    """One claimable unit: a (scenario, overrides, algo) group's seed
    slice, plus the item keys it is expected to produce (the coordinator
    audits completeness against them)."""

    name: str
    scenario: str
    overrides: Tuple[Tuple[str, Any], ...]
    algo: str
    seeds: Tuple[int, ...]
    n_ticks: int
    keys: Tuple[str, ...]

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "scenario": self.scenario,
                "overrides": [list(kv) for kv in self.overrides],
                "algo": self.algo, "seeds": list(self.seeds),
                "n_ticks": self.n_ticks, "keys": list(self.keys)}

    @classmethod
    def from_json(cls, doc: Mapping[str, Any]) -> "Task":
        return cls(name=str(doc["name"]), scenario=str(doc["scenario"]),
                   overrides=tuple((str(k), v)
                                   for k, v in doc["overrides"]),
                   algo=str(doc["algo"]),
                   seeds=tuple(int(s) for s in doc["seeds"]),
                   n_ticks=int(doc["n_ticks"]),
                   keys=tuple(str(k) for k in doc["keys"]))


def _write_atomic(path: Path, doc: Mapping[str, Any]) -> None:
    """Crash-safe JSON publish — the store's shared fsync'd
    tempfile+rename primitive."""
    atomic_write(path, json.dumps(doc, indent=1).encode())


def _read_json(path: Path) -> Optional[Dict[str, Any]]:
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None  # vanished mid-scan (raced transition) or mid-write


@dataclasses.dataclass
class Lease:
    """A claimed task. The holder renews it while executing; anyone may
    requeue it once ``expires_at`` passes."""

    queue: "LeaseQueue"
    task: Task
    owner: str
    expires_at: float
    lost: bool = False

    @property
    def path(self) -> Path:
        return self.queue.lease_dir / f"{self.task.name}.json"

    def _still_mine(self) -> bool:
        """Ownership check against the on-disk lease: after an expiry
        reap, the same path may hold *another* worker's lease on the same
        task — a stale holder must neither renew over it nor complete it.
        (The read-then-act window is unsynchronized, but both outcomes
        are benign: results are appended before completion, and the merge
        verifies duplicates bit-for-bit.)"""
        if self.lost:
            return False
        doc = _read_json(self.path)
        if doc is None:
            self.lost = True
            return False
        owner = doc.get("lease", {}).get("owner", self.owner)
        if owner != self.owner:
            self.lost = True
            return False
        return True

    def renew(self, ttl: Optional[float] = None) -> bool:
        """Push ``expires_at`` out by ``ttl`` (the heartbeat). Returns
        False — and flags the lease lost — if the lease was reaped after
        an expiry (the task is someone else's now)."""
        if not self._still_mine():
            return False
        self.expires_at = time.time() + float(ttl or self.queue.ttl)
        doc = self.task.to_json()
        doc["lease"] = {"owner": self.owner, "expires_at": self.expires_at}
        _write_atomic(self.path, doc)
        return True

    def complete(self) -> bool:
        """tasks→done transition; False if the lease was lost meanwhile
        (results are still durable in the worker's store — the merge
        dedups the re-executed duplicate)."""
        if not self._still_mine():
            return False
        try:
            os.rename(self.path, self.queue.done_dir /
                      f"{self.task.name}.json")
            return True
        except OSError:
            self.lost = True
            return False

    def release(self) -> bool:
        """Give the (unfinished) task back to the queue."""
        if not self._still_mine():
            return False
        doc = self.task.to_json()  # strip the lease block
        try:
            _write_atomic(self.path, doc)
            os.rename(self.path, self.queue.task_dir /
                      f"{self.task.name}.json")
            return True
        except OSError:
            self.lost = True
            return False


class LeaseQueue:
    """The shared task queue under ``<fleet_root>/queue``."""

    def __init__(self, root: os.PathLike | str, *,
                 owner: Optional[str] = None, ttl: float = DEFAULT_TTL_S,
                 create: bool = True):
        """``create=False`` is for read-side consumers (status/reap over
        an operator-typed path): a queue that does not exist is an error
        to report, not an empty-healthy one to silently fabricate."""
        self.root = Path(root)
        self.task_dir = self.root / _TASKS
        self.lease_dir = self.root / _LEASES
        self.done_dir = self.root / _DONE
        if create:
            for d in (self.task_dir, self.lease_dir, self.done_dir):
                d.mkdir(parents=True, exist_ok=True)
        elif not self.task_dir.is_dir():
            # the reference's words: `obs tail` prints them as they are
            raise ValueError(f"no fleet queue at {self.root} — "
                             f"run `repro.fleet plan` first (or check "
                             f"the --root path)")
        self.owner = owner or default_owner()
        self.ttl = float(ttl)

    # -- enqueue ----------------------------------------------------------
    def put(self, task: Task) -> bool:
        """Enqueue ``task`` unless it already exists in any state (makes
        re-planning idempotent). Returns True if enqueued."""
        name = f"{task.name}.json"
        if any((d / name).exists()
               for d in (self.task_dir, self.lease_dir, self.done_dir)):
            return False
        _write_atomic(self.task_dir / name, task.to_json())
        return True

    # -- listing ----------------------------------------------------------
    def _names(self, d: Path) -> List[str]:
        return sorted(p.stem for p in d.glob("*.json"))

    def pending(self) -> List[str]:
        return self._names(self.task_dir)

    def leased(self) -> List[str]:
        return self._names(self.lease_dir)

    def done(self) -> List[str]:
        return self._names(self.done_dir)

    def read_task(self, name: str) -> Optional[Task]:
        for d in (self.task_dir, self.lease_dir, self.done_dir):
            doc = _read_json(d / f"{name}.json")
            if doc is not None:
                return Task.from_json(doc)
        return None

    # -- claim / recover --------------------------------------------------
    def claim(self) -> Optional[Lease]:
        """Claim the first available task, or None when none is claimable.

        The claim itself is ``rename(tasks/T, leases/T)`` — atomic, single
        winner even with N workers scanning the same directory; losers see
        ``ENOENT`` and move on to the next candidate.
        """
        for name in self.pending():
            src = self.task_dir / f"{name}.json"
            dst = self.lease_dir / f"{name}.json"
            try:
                os.rename(src, dst)
            except OSError:
                continue  # raced: someone else claimed (or reaped) it
            doc = _read_json(dst)
            if doc is None:
                # unreadable task file (external corruption — our own
                # writes are atomic): quarantine it visibly instead of
                # parking an unreapable lease; status() reports it
                with contextlib.suppress(OSError):
                    os.rename(dst, Path(str(dst) + _POISON_SUFFIX))
                continue
            lease = Lease(queue=self, task=Task.from_json(doc),
                          owner=self.owner, expires_at=0.0)
            lease.renew()
            return lease
        return None

    def _lease_expiry(self, path: Path) -> Optional[float]:
        doc = _read_json(path)
        if doc is None:
            return None  # raced transition; not ours to judge
        lease = doc.get("lease")
        if lease is not None:
            return float(lease.get("expires_at", 0.0))
        # claimed but killed before the lease block landed: fall back to
        # the rename mtime + one TTL
        try:
            return path.stat().st_mtime + self.ttl
        except OSError:
            return None

    def reap(self, now: Optional[float] = None) -> List[str]:
        """Requeue every expired lease (crash recovery); returns the
        requeued task names. Safe to call from any process at any time."""
        now = time.time() if now is None else float(now)
        reaped: List[str] = []
        for name in self.leased():
            path = self.lease_dir / f"{name}.json"
            expiry = self._lease_expiry(path)
            if expiry is None or expiry > now:
                continue
            doc = _read_json(path)
            if doc is None:
                continue
            doc.pop("lease", None)
            try:
                _write_atomic(path, doc)
                os.rename(path, self.task_dir / f"{name}.json")
            except OSError:
                continue  # raced with the owner's complete()/heartbeat
            reaped.append(name)
        return reaped

    # -- accounting -------------------------------------------------------
    def status(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = time.time() if now is None else float(now)
        expired = []
        for name in self.leased():
            expiry = self._lease_expiry(self.lease_dir / f"{name}.json")
            if expiry is not None and expiry <= now:
                expired.append(name)
        return {"pending": len(self.pending()),
                "leased": len(self.leased()),
                "expired": len(expired),
                "done": len(self.done()),
                "expired_names": expired,
                "poisoned": sorted(
                    p.name for p in
                    self.lease_dir.glob("*" + _POISON_SUFFIX))}
