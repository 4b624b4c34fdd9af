"""Live telemetry streaming: a versioned JSONL wire protocol over a
unix/TCP socket or an append-only file tail (the port of
:mod:`repro.obs.stream`; the wire format is the reference's, so either
package reads the other's streams).

The tracer makes the hot paths *record* — spans, counters, gauges,
histograms — into process-local buffers that are only visible once the
process saves an artifact. This module makes that telemetry *flow* while
the process runs: a :class:`StreamPublisher` tails the live
:class:`~repro_torch.obs.metrics.MetricsRegistry` and the per-tick gauges
and pushes versioned frames to whoever is watching (``python -m
repro_torch.obs dash``, or any ``tail -f`` + ``jq`` pipeline).

Wire protocol (``stream_schema`` :data:`STREAM_SCHEMA_VERSION`): one JSON
object per ``\\n``-terminated line. The first frame is a **handshake**::

    {"stream_schema": 1, "seq": 0, "type": "hello",
     "t": <wall s>, "payload": {"source": ..., "pid": ...}}

Every subsequent frame carries a strictly increasing ``seq``; readers
(:func:`read_stream` / :class:`FrameValidator`) reject streams with a
missing or version-mismatched handshake, non-monotonic ``seq`` (an
out-of-order or replayed frame), and complete lines that fail to parse
(a torn write). An *incomplete* trailing line — a frame still being
written — is never parsed: file readers buffer until the newline lands,
so tailing a live stream can't see a half-frame. Frame types in use:
``hello``, ``tick`` (per serving-horizon tick), ``horizon`` (end-of-run
summary), ``gateway`` (the live control plane's per-tick frames),
``chunk`` (sweep chunk completions), ``worker`` (fleet task completions,
written by the reference's fleet), ``metrics`` (a full registry
snapshot), ``bye``.

Transports: ``unix:<path>`` binds a unix-domain socket and broadcasts to
every connected client (slow or dead clients are dropped, never waited
on); ``tcp:<host>:<port>`` does the same over TCP; anything else is a
file path appended to — the fallback that works across any shared
filesystem (the reference's fleet writes one file per worker under
``<fleet_root>/stream/``).

Opt-in mirrors the tracer: ``REPRO_OBS_STREAM=<spec>`` in the
environment (``1`` means "the default file sink"), or an explicit
:func:`enable_stream` / CLI flag. The tracer's invariant carries over
and is tested: streaming is observational only — stores and
``TickReport``\\ s are byte-identical stream-on vs stream-off, and a
publisher failure (full disk, dead socket) disables the stream rather
than failing the serving path.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "STREAM_SCHEMA_VERSION",
    "StreamError",
    "FileSink",
    "SocketSink",
    "StreamPublisher",
    "FrameValidator",
    "parse_stream_spec",
    "read_stream",
    "enable_stream",
    "disable_stream",
    "stream_active",
    "get_publisher",
    "publish",
    "enable_stream_from_env",
]

#: Version stamp of the wire protocol (the handshake frame carries it).
STREAM_SCHEMA_VERSION = 1

_ENV_STREAM = "REPRO_OBS_STREAM"

_TRUTHY = ("1", "true", "on")


class StreamError(ValueError):
    """A malformed stream: bad handshake, torn frame, out-of-order seq."""


# ===========================================================================
# Sinks (publisher side)
# ===========================================================================

class FileSink:
    """Append frames to a JSONL file — the lowest-common-denominator
    transport: works over any shared filesystem, readable with ``tail -f``.
    One publisher per file (the seq contiguity contract is per-writer)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)  # line-buffered

    def write(self, line: str) -> None:
        self._f.write(line)
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    def describe(self) -> str:
        return str(self.path)


class SocketSink:
    """Bind a unix/TCP socket and broadcast every frame to all connected
    clients. Strictly best-effort: a slow or dead client is dropped (the
    publisher never blocks on a reader), and a late joiner is replayed
    the handshake frame so validation still works mid-run. The accept
    thread polls its socket, so :meth:`close` stops and joins it."""

    #: seconds the accept thread waits on its socket between checks of
    #: the closed flag (bounds how long :meth:`close` waits for it)
    POLL_S = 0.05

    def __init__(self, kind: str, address):
        self.kind = kind
        self.address = address
        if kind == "unix":
            self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                os.unlink(address)
            except OSError:
                pass
            Path(address).parent.mkdir(parents=True, exist_ok=True)
            self._srv.bind(address)
        elif kind == "tcp":
            self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._srv.bind(address)
            self.address = self._srv.getsockname()  # resolved port 0
        else:
            raise ValueError(f"unknown socket kind {kind!r}")
        self._srv.listen(8)
        self._srv.settimeout(self.POLL_S)
        self._lock = threading.Lock()
        self._clients: List[socket.socket] = []
        self._hello: Optional[str] = None
        self._closed = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # closed underneath us
            conn.setblocking(False)
            with self._lock:
                if self._hello is not None:
                    try:
                        conn.sendall(self._hello.encode())
                    except OSError:
                        conn.close()
                        continue
                self._clients.append(conn)

    def write(self, line: str) -> None:
        data = line.encode()
        with self._lock:
            if self._hello is None:
                self._hello = line
            dead = []
            for conn in self._clients:
                try:
                    conn.sendall(data)
                except OSError:  # includes EWOULDBLOCK: drop slow readers
                    dead.append(conn)
            for conn in dead:
                self._clients.remove(conn)
                conn.close()

    def close(self) -> None:
        self._closed = True
        self._thread.join()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            for conn in self._clients:
                try:
                    conn.close()
                except OSError:
                    pass
            self._clients.clear()
        if self.kind == "unix":
            try:
                os.unlink(self.address)
            except OSError:
                pass

    def describe(self) -> str:
        if self.kind == "unix":
            return f"unix:{self.address}"
        host, port = self.address
        return f"tcp:{host}:{port}"


def parse_stream_spec(spec: str, default_path: Optional[str] = None
                      ) -> Tuple[str, Any]:
    """``unix:/path`` / ``tcp:host:port`` / file path → (kind, address).

    A bare truthy value (``1``/``true``/``on``) selects the default file
    sink — ``default_path`` or ``obs_stream.jsonl`` in the cwd.
    """
    spec = str(spec).strip()
    if spec.lower() in _TRUTHY:
        return "file", str(default_path or "obs_stream.jsonl")
    if spec.startswith("unix:"):
        return "unix", spec[len("unix:"):]
    if spec.startswith("tcp:"):
        rest = spec[len("tcp:"):]
        host, _, port = rest.rpartition(":")
        return "tcp", (host or "127.0.0.1", int(port))
    return "file", spec


def _open_sink(spec: str, default_path: Optional[str] = None):
    kind, address = parse_stream_spec(spec, default_path)
    if kind == "file":
        return FileSink(address)
    return SocketSink(kind, address)


# ===========================================================================
# Publisher
# ===========================================================================

class StreamPublisher:
    """Frame writer over one sink; thread-safe, best-effort, versioned.

    Emits the handshake at construction. ``emit`` never raises into the
    instrumented caller: a sink failure closes the stream and subsequent
    emits are dropped (``self.failed`` flips so callers can report it).
    """

    def __init__(self, sink, *, source: str = "repro",
                 clock: Callable[[], float] = time.time):
        self._sink = sink
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self.failed = False
        self.n_frames = 0
        self.emit("hello", {
            "stream_schema": STREAM_SCHEMA_VERSION,
            "source": str(source),
            "pid": os.getpid(),
        })

    def emit(self, type_: str, payload: Dict[str, Any]) -> bool:
        """Write one frame; returns False when the stream is dead."""
        if self.failed:
            return False
        with self._lock:
            frame = {
                "stream_schema": STREAM_SCHEMA_VERSION,
                "seq": self._seq,
                "t": round(float(self._clock()), 6),
                "type": str(type_),
                "payload": payload,
            }
            line = json.dumps(frame, separators=(",", ":"),
                              sort_keys=True) + "\n"
            try:
                self._sink.write(line)
            except (OSError, ValueError):
                # ValueError covers writes to an already-closed file —
                # streaming must degrade, never raise into the hot path
                self.failed = True
                try:
                    self._sink.close()
                except (OSError, ValueError):
                    pass
                return False
            self._seq += 1
            self.n_frames += 1
            return True

    def emit_metrics(self, tracer) -> bool:
        """One ``metrics`` frame: the registry snapshot + counters of a
        live :class:`~repro_torch.obs.trace.Tracer` — the "tail the registry"
        half of the stream."""
        return self.emit("metrics", {
            "metrics": tracer.metrics.snapshot(),
            "counters": dict(tracer.counters),
            "n_spans": tracer.n_spans,
        })

    def close(self) -> None:
        if not self.failed:
            self.emit("bye", {"n_frames": self.n_frames})
        try:
            self._sink.close()
        except OSError:
            pass

    def describe(self) -> str:
        return self._sink.describe()


# ===========================================================================
# Reader / validator
# ===========================================================================

class FrameValidator:
    """Stateful frame checker shared by every consumer.

    Rules (violations raise :class:`StreamError`):

    - the first frame must be a ``hello`` whose ``stream_schema`` matches
      :data:`STREAM_SCHEMA_VERSION` (the versioned handshake);
    - ``seq`` must be strictly increasing — an out-of-order or replayed
      frame is rejected; with ``contiguous=True`` (file streams, where
      no frame can be legitimately dropped) any gap is also rejected;
    - every frame must be a complete, parseable JSON object (a complete
      line that fails to parse is a torn write, not a partial tail).
    """

    def __init__(self, *, contiguous: bool = True):
        self.contiguous = contiguous
        self.last_seq: Optional[int] = None
        self.hello: Optional[Dict[str, Any]] = None

    def reset(self) -> None:
        """Forget all state — the stream restarted (file truncated or
        rotated), so the next frame must be a fresh hello handshake."""
        self.last_seq = None
        self.hello = None

    def feed_line(self, line: str) -> Dict[str, Any]:
        try:
            frame = json.loads(line)
        except json.JSONDecodeError as e:
            raise StreamError(f"truncated/corrupt frame: {line!r:.80}") \
                from e
        if not isinstance(frame, dict):
            raise StreamError(f"frame is not an object: {line!r:.80}")
        return self.feed(frame)

    def feed(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        seq = frame.get("seq")
        if not isinstance(seq, int):
            raise StreamError(f"frame without integer seq: {frame!r:.120}")
        if self.hello is None:
            if frame.get("type") != "hello":
                raise StreamError(
                    f"stream does not start with a hello handshake "
                    f"(got type={frame.get('type')!r})")
            have = frame.get("payload", {}).get("stream_schema",
                                                frame.get("stream_schema"))
            if have != STREAM_SCHEMA_VERSION:
                raise StreamError(
                    f"stream handshake schema v{have}, this code reads "
                    f"v{STREAM_SCHEMA_VERSION}")
            self.hello = frame
        if self.last_seq is not None:
            if seq <= self.last_seq:
                raise StreamError(f"out-of-order frame: seq {seq} after "
                                  f"{self.last_seq}")
            if self.contiguous and seq != self.last_seq + 1:
                raise StreamError(f"missing frame(s): seq jumped "
                                  f"{self.last_seq} -> {seq}")
        self.last_seq = seq
        return frame


def read_stream(spec: str, *, follow: bool = False,
                timeout_s: float = 5.0, poll_s: float = 0.05,
                validator: Optional[FrameValidator] = None
                ) -> Iterator[Dict[str, Any]]:
    """Yield validated frames from a stream spec (file path or socket).

    File mode buffers partial lines (a frame mid-write is invisible, not
    an error) and, with ``follow=True``, keeps polling for new frames
    until ``timeout_s`` passes with no progress or a ``bye`` frame
    arrives. Socket mode connects as a client; socket streams validate
    non-contiguously (a broadcaster drops frames for slow clients).
    """
    kind, address = parse_stream_spec(spec)
    if kind == "file":
        validator = validator or FrameValidator(contiguous=True)
        yield from _read_file(Path(address), follow, timeout_s, poll_s,
                              validator)
    else:
        validator = validator or FrameValidator(contiguous=False)
        yield from _read_socket(kind, address, timeout_s, validator)


def _read_file(path: Path, follow: bool, timeout_s: float, poll_s: float,
               validator: FrameValidator) -> Iterator[Dict[str, Any]]:
    buf = ""
    pos = 0
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            # A shrunken file means the writer truncated or rotated the
            # stream in place: restart from offset 0 with fresh validator
            # state (the new stream begins with its own hello handshake).
            if pos and os.stat(path).st_size < pos:
                pos = 0
                buf = ""
                validator.reset()
            with open(path) as f:
                f.seek(pos)
                chunk = f.read()
                pos = f.tell()
        except FileNotFoundError:
            chunk = ""
        if chunk:
            buf += chunk
            deadline = time.monotonic() + timeout_s
            while "\n" in buf:
                line, buf = buf.split("\n", 1)
                if not line.strip():
                    continue
                frame = validator.feed_line(line)
                yield frame
                if frame.get("type") == "bye":
                    return
        if not follow:
            return
        if time.monotonic() >= deadline:
            return
        time.sleep(poll_s)


def _read_socket(kind: str, address, timeout_s: float,
                 validator: FrameValidator) -> Iterator[Dict[str, Any]]:
    family = socket.AF_UNIX if kind == "unix" else socket.AF_INET
    with socket.socket(family, socket.SOCK_STREAM) as conn:
        conn.settimeout(timeout_s)
        conn.connect(address)
        buf = b""
        while True:
            try:
                chunk = conn.recv(65536)
            except socket.timeout:
                return
            if not chunk:
                return
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if not line.strip():
                    continue
                frame = validator.feed_line(line.decode())
                yield frame
                if frame.get("type") == "bye":
                    return


# ===========================================================================
# Module-level switch (mirrors trace.enable/disable)
# ===========================================================================

_PUBLISHER: Optional[StreamPublisher] = None


def enable_stream(spec: str, *, source: str = "repro",
                  default_path: Optional[str] = None) -> StreamPublisher:
    """Install (and return) the process-global stream publisher."""
    global _PUBLISHER
    if _PUBLISHER is not None:
        _PUBLISHER.close()
    _PUBLISHER = StreamPublisher(_open_sink(spec, default_path),
                                 source=source)
    return _PUBLISHER


def disable_stream() -> Optional[StreamPublisher]:
    """Close and uninstall the global publisher (emits the bye frame)."""
    global _PUBLISHER
    pub, _PUBLISHER = _PUBLISHER, None
    if pub is not None:
        pub.close()
    return pub


def stream_active() -> bool:
    return _PUBLISHER is not None and not _PUBLISHER.failed


def get_publisher() -> Optional[StreamPublisher]:
    return _PUBLISHER


def publish(type_: str, **payload: Any) -> bool:
    """The one hot-path hook: a no-op (one global load + ``None`` check)
    unless a publisher is installed."""
    pub = _PUBLISHER
    if pub is None:
        return False
    return pub.emit(type_, payload)


def enable_stream_from_env(default_path: Optional[str] = None,
                           source: str = "repro"
                           ) -> Optional[StreamPublisher]:
    """Opt-in via ``REPRO_OBS_STREAM`` — how forked fleet workers inherit
    streaming. The value is a stream spec (``unix:...``, ``tcp:...``, a
    file path) or a bare ``1`` for the default file sink; anything else
    leaves streaming off. Registers an :mod:`atexit` close so the bye
    frame lands on clean exit."""
    spec = os.environ.get(_ENV_STREAM, "").strip()
    if not spec or spec.lower() in ("0", "false", "off"):
        return None
    pub = enable_stream(spec, source=source, default_path=default_path)
    import atexit
    atexit.register(disable_stream)
    return pub
