"""Persistent multi-tenant cost-model server (docs/SERVING.md §server).

`CostModelService` is in-process only — one Python process, one
client. This module wraps it in a long-lived socket server so many
concurrent search clients (the paper's "access to TPUs is limited or
expensive" deployment: autotuners hammering one shared model) share one
cache, one coalescer, and one model on the card:

* **Protocol** — length-prefixed JSON frames (4-byte big-endian length +
  UTF-8 JSON body) over TCP. Graphs travel as `KernelGraph.to_dict()`
  payloads; scores come back as JSON doubles (float32 values are exact in
  a double, so the wire round trip is bit-identical).
* **Admission control** — a bounded work queue plus a per-request
  deadline. A full queue answers `overloaded` *immediately* (shed, never
  hang); a request whose deadline passed while queued answers
  `deadline_exceeded` without touching the model. Both are explicit,
  counted responses — the load benchmark gates that nothing is ever
  silently dropped.
* **Cross-client coalescing** — one scoring worker drains the queue in
  batches and funnels every request through `CostModelService.submit`,
  so identical graphs from *different* sockets share one coalescer
  ticket and one model evaluation per flush.
* **Warm cache** — with `snapshot_path=`, `start()` restores a persisted
  `PredictionCache` snapshot (content-addressed npz, `serving.cache`)
  and `stop()` writes one, so a restarted server answers replayed
  traffic from disk.
* **Fault injection** — a structured `FaultPolicy` (drop connection,
  delay, corrupt frame, kill the scoring worker mid-flush) threaded
  through the response path for the concurrency/fault test suite
  (`tests/test_server.py`). Off by default.

Counterpart of `repro.serving.server`, the same protocol byte for byte:
a client of either package talks to a server of either. This module
stays numpy+stdlib at import time (the service object is passed in,
torch arrives with it) so clients and test harnesses can import the
protocol pieces without paying the torch import. The scoring worker is
a thread of its own: `core.evaluate.make_predict_fn` enters inference
mode and each kernel wrapper selects its tensors' device inside that
thread, and an error there (a CUDA one too) answers the batch with a
`worker_failure` frame; nothing is retried elsewhere.

>>> buf = pack_frame({"op": "ping"})
>>> import struct
>>> struct.unpack(">I", buf[:4])[0] == len(buf) - 4
True
>>> unpack_frame(buf[4:])
{'op': 'ping'}
>>> FaultPolicy("delay", every=3).matches(6)
True
>>> FaultPolicy("drop", requests=(2,)).matches(3)
False
"""
from __future__ import annotations

import json
import os
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass

from repro_torch.core.graph import KernelGraph

# --------------------------------------------------------------------------
# Framing
# --------------------------------------------------------------------------
MAX_FRAME_BYTES = 64 << 20          # hard cap against hostile/corrupt lengths
_LEN = struct.Struct(">I")


class FrameError(Exception):
    """Malformed wire data: oversize length, truncated frame, bad JSON."""


def pack_frame(doc: dict) -> bytes:
    """Serialize one protocol message: 4-byte big-endian length + JSON."""
    body = json.dumps(doc, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME_BYTES:
        raise FrameError(f"frame of {len(body)} bytes exceeds "
                         f"{MAX_FRAME_BYTES}")
    return _LEN.pack(len(body)) + body


def unpack_frame(body: bytes) -> dict:
    """Decode a frame body; raises `FrameError` on bad JSON / non-object."""
    try:
        doc = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise FrameError(f"undecodable frame body: {e}") from e
    if not isinstance(doc, dict):
        raise FrameError(f"frame body is {type(doc).__name__}, expected "
                         "object")
    return doc


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """Read exactly `n` bytes; None on clean EOF at a frame boundary."""
    chunks, got = [], 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0:
                return None
            raise FrameError(f"connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> dict | None:
    """Read one frame off `sock`; None on clean EOF before a frame starts."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (length,) = _LEN.unpack(head)
    if length > MAX_FRAME_BYTES:
        raise FrameError(f"declared frame length {length} exceeds "
                         f"{MAX_FRAME_BYTES}")
    body = _recv_exact(sock, length)
    if body is None:
        raise FrameError("connection closed between length and body")
    return unpack_frame(body)


def send_frame(sock: socket.socket, doc: dict) -> None:
    sock.sendall(pack_frame(doc))


# --------------------------------------------------------------------------
# Fault injection
# --------------------------------------------------------------------------
FAULT_MODES = ("drop", "delay", "corrupt", "kill_flush")


@dataclass(frozen=True)
class FaultPolicy:
    """Deterministic per-request fault selector for the test suite.

    Matches on the server's global predict-request sequence number
    (1-based): `requests` is an explicit set of sequence numbers, `every`
    fires on every k-th request; either alone or both together.

    Modes (applied by the server, see `CostModelServer`):

    * ``drop``       — close the connection instead of responding;
    * ``delay``      — sleep `delay_s` before sending the response;
    * ``corrupt``    — send a correctly-framed garbage body;
    * ``kill_flush`` — raise inside the scoring worker mid-flush (after
      requests were submitted to the coalescer, before their batch
      resolves), killing that worker pass; the server answers the whole
      batch with a clean `worker_failure` error and keeps serving.
    """
    mode: str
    requests: tuple[int, ...] = ()
    every: int | None = None
    delay_s: float = 0.05

    def __post_init__(self):
        if self.mode not in FAULT_MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; "
                             f"expected one of {FAULT_MODES}")
        object.__setattr__(self, "requests", tuple(self.requests))

    def matches(self, seq: int) -> bool:
        if seq in self.requests:
            return True
        return bool(self.every) and seq % self.every == 0


class _InjectedFault(Exception):
    """Raised by the scoring worker for `kill_flush` faults."""


# --------------------------------------------------------------------------
# Server
# --------------------------------------------------------------------------
@dataclass
class ServerStats:
    """Server-level counters (the service keeps its own cache/flush stats)."""
    connections: int = 0
    requests: int = 0                 # predict requests admitted or shed
    completed: int = 0                # predict requests answered with scores
    shed_overloaded: int = 0          # rejected at admission (queue full)
    shed_deadline: int = 0            # expired while queued
    worker_failures: int = 0          # scoring passes killed (faults/bugs)
    faults_injected: int = 0
    restored_entries: int = 0         # warm-cache entries loaded at start

    def to_dict(self) -> dict:
        return {k: int(getattr(self, k)) for k in (
            "connections", "requests", "completed", "shed_overloaded",
            "shed_deadline", "worker_failures", "faults_injected",
            "restored_entries")}


@dataclass
class _Work:
    """One admitted predict request, queued for the scoring worker."""
    sock: socket.socket
    send_lock: threading.Lock
    req_id: object
    graphs: list
    deadline: float | None            # absolute time.monotonic() cutoff
    fault: FaultPolicy | None
    seq: int


_STOP = object()                      # queue sentinel


class CostModelServer:
    """Length-prefixed-JSON socket server around one `CostModelService`.

    One accept thread, one connection thread per client (they parse and
    decode off the scoring path), one scoring worker that drains the
    bounded queue in batches and pushes everything through
    `service.submit` + one `service.flush` — the cross-client coalescing
    path. Admission (queue full → `overloaded`) and deadline expiry
    (`deadline_exceeded`) are answered from the connection/worker threads
    without scoring, so an overloaded server sheds explicitly instead of
    stalling every client.

    Parameters:
      service             a `CostModelService` (or any object with
                          `submit/flush/stats/snapshot_cache/restore_cache`)
      host, port          bind address; port 0 picks a free port
      max_queue           admission bound (queued predict requests)
      coalesce_limit      max requests one worker pass drains into a batch
      default_deadline_ms deadline applied when a request carries none
                          (None: no default deadline)
      snapshot_path       warm-cache npz: restored on `start()` (if the
                          file exists), written on `stop()` and on the
                          `snapshot` op
      fault_policy        server-side `FaultPolicy` (tests only)
      allow_request_faults honor a per-request ``"fault"`` dict from the
                          client (tests only)
    """

    def __init__(self, service, *, host: str = "127.0.0.1", port: int = 0,
                 max_queue: int = 64, coalesce_limit: int = 32,
                 default_deadline_ms: float | None = None,
                 snapshot_path: str | None = None,
                 fault_policy: FaultPolicy | None = None,
                 allow_request_faults: bool = False):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if coalesce_limit < 1:
            raise ValueError("coalesce_limit must be >= 1")
        self.service = service
        self.host, self.port = host, int(port)
        self.max_queue = int(max_queue)
        self.coalesce_limit = int(coalesce_limit)
        self.default_deadline_ms = default_deadline_ms
        self.snapshot_path = snapshot_path
        self.fault_policy = fault_policy
        self.allow_request_faults = bool(allow_request_faults)
        self.stats = ServerStats()
        self._queue: queue.Queue = queue.Queue(maxsize=self.max_queue)
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._conn_threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()           # conns + counters
        self._seq = 0
        self._running = False

    # -- lifecycle ----------------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        """(host, port) actually bound — read after `start()`."""
        if self._listener is None:
            raise RuntimeError("server not started")
        return self._listener.getsockname()[:2]

    @property
    def running(self) -> bool:
        return self._running

    def start(self) -> "CostModelServer":
        if self._running:
            raise RuntimeError("server already started")
        if self.snapshot_path and os.path.exists(self.snapshot_path):
            self.stats.restored_entries = self.service.restore_cache(
                self.snapshot_path)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(128)
        self._running = True
        for name, target in (("accept", self._accept_loop),
                             ("worker", self._worker_loop)):
            t = threading.Thread(target=target,
                                 name=f"costmodel-server-{name}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self, *, timeout: float = 10.0) -> None:
        """Graceful shutdown: stop accepting, let the worker finish its
        current batch, answer everything still queued with
        `shutting_down`, close every connection, join every thread, and
        persist the warm cache. Idempotent."""
        if not self._running:
            return
        self._running = False
        if self._listener is not None:
            # shutdown() wakes a thread blocked in accept(); close() alone
            # can leave it parked on the fd forever
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        self._queue.put(_STOP)         # blocking: guaranteed delivery
        for t in self._threads:
            t.join(timeout=timeout)
        # fail whatever the worker never reached — no silent drops
        while True:
            try:
                w = self._queue.get_nowait()
            except queue.Empty:
                break
            if w is not _STOP:
                self._respond_error(w, "shutting_down",
                                    "server stopped before scoring")
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            self._close_conn(c)
        for t in list(self._conn_threads):
            t.join(timeout=timeout)
        self._threads.clear()
        self._conn_threads.clear()
        if self.snapshot_path:
            self.service.snapshot_cache(self.snapshot_path)

    def __enter__(self) -> "CostModelServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- accept / connection threads ---------------------------------------
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                break                  # listener closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if not self._running:
                    conn.close()
                    break
                self._conns.add(conn)
                self.stats.connections += 1
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 name="costmodel-server-conn", daemon=True)
            t.start()
            # prune finished handlers so long-lived servers don't hoard them
            self._conn_threads = [c for c in self._conn_threads
                                  if c.is_alive()]
            self._conn_threads.append(t)

    def _close_conn(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.discard(conn)
        try:
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass

    def _conn_loop(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        try:
            while self._running:
                try:
                    req = recv_frame(conn)
                except (FrameError, OSError):
                    break              # protocol violation / reset: drop
                if req is None:
                    break              # client closed cleanly
                self._dispatch(conn, send_lock, req)
        finally:
            self._close_conn(conn)

    def _dispatch(self, conn, send_lock, req: dict) -> None:
        op = req.get("op")
        req_id = req.get("id")
        if op == "predict":
            self._admit(conn, send_lock, req)
        elif op == "ping":
            self._send(conn, send_lock,
                       {"id": req_id, "ok": True, "pong": time.time()})
        elif op == "stats":
            self._send(conn, send_lock,
                       {"id": req_id, "ok": True, "server": self.stats.to_dict(),
                        "service": _service_stats_doc(self.service)})
        elif op == "snapshot":
            path = req.get("path") or self.snapshot_path
            if not path:
                self._send(conn, send_lock,
                           {"id": req_id, "ok": False, "error": "bad_request",
                            "detail": "no snapshot path configured"})
                return
            n = self.service.snapshot_cache(path)
            self._send(conn, send_lock,
                       {"id": req_id, "ok": True, "entries": n, "path": path})
        elif op == "shutdown":
            self._send(conn, send_lock, {"id": req_id, "ok": True})
            threading.Thread(target=self.stop, daemon=True).start()
        else:
            self._send(conn, send_lock,
                       {"id": req_id, "ok": False, "error": "bad_request",
                        "detail": f"unknown op {op!r}"})

    def _admit(self, conn, send_lock, req: dict) -> None:
        req_id = req.get("id")
        with self._lock:
            self._seq += 1
            seq = self._seq
            self.stats.requests += 1
        fault = self._fault_for(seq, req)
        try:
            graphs = [KernelGraph.from_dict(g) for g in req["graphs"]]
        except (KeyError, TypeError, ValueError) as e:
            self._send(conn, send_lock,
                       {"id": req_id, "ok": False, "error": "bad_request",
                        "detail": f"undecodable graphs: {e}"})
            return
        deadline_ms = req.get("deadline_ms", self.default_deadline_ms)
        deadline = (time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        work = _Work(conn, send_lock, req_id, graphs, deadline, fault, seq)
        try:
            self._queue.put_nowait(work)
        except queue.Full:
            with self._lock:
                self.stats.shed_overloaded += 1
            self._respond_error(work, "overloaded",
                                f"admission queue full ({self.max_queue})")

    def _fault_for(self, seq: int, req: dict) -> FaultPolicy | None:
        if self.allow_request_faults and req.get("fault"):
            f = dict(req["fault"])
            return FaultPolicy(f["mode"], delay_s=float(f.get("delay_s",
                                                              0.05)))
        if self.fault_policy is not None and self.fault_policy.matches(seq):
            return self.fault_policy
        return None

    # -- scoring worker -----------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            work = self._queue.get()
            if work is _STOP:
                return
            batch = [work]
            # drain whatever is already queued: cross-client batching
            while len(batch) < self.coalesce_limit:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    self._queue.put(nxt)      # re-deliver for ourselves
                    break
                batch.append(nxt)
            now = time.monotonic()
            ready = []
            for w in batch:
                if w.deadline is not None and now > w.deadline:
                    with self._lock:
                        self.stats.shed_deadline += 1
                    self._respond_error(w, "deadline_exceeded",
                                        "expired while queued")
                else:
                    ready.append(w)
            if not ready:
                continue
            try:
                pendings = [self.service.submit(w.graphs) for w in ready]
                for w in ready:
                    if w.fault is not None and w.fault.mode == "kill_flush":
                        with self._lock:
                            self.stats.faults_injected += 1
                        raise _InjectedFault(f"kill_flush at seq {w.seq}")
                self.service.flush()
                results = [p.result() for p in pendings]
            except Exception as e:             # noqa: BLE001 — keep serving
                with self._lock:
                    self.stats.worker_failures += 1
                for w in ready:
                    self._respond_error(w, "worker_failure",
                                        f"{type(e).__name__}: {e}")
                continue
            for w, scores in zip(ready, results):
                self._respond_scores(w, scores)

    # -- responses ----------------------------------------------------------
    def _respond_scores(self, w: _Work, scores) -> None:
        with self._lock:
            self.stats.completed += 1
        self._respond(w, {"id": w.req_id, "ok": True,
                          "scores": [float(s) for s in scores]})

    def _respond_error(self, w: _Work, error: str, detail: str) -> None:
        self._respond(w, {"id": w.req_id, "ok": False, "error": error,
                          "detail": detail})

    def _respond(self, w: _Work, doc: dict) -> None:
        fault = w.fault
        if fault is not None and fault.mode in ("drop", "delay", "corrupt"):
            with self._lock:
                self.stats.faults_injected += 1
            if fault.mode == "drop":
                self._close_conn(w.sock)
                return
            if fault.mode == "delay":
                time.sleep(fault.delay_s)
            elif fault.mode == "corrupt":
                body = b"\xff" * 24            # framed, but not JSON
                try:
                    with w.send_lock:
                        w.sock.sendall(_LEN.pack(len(body)) + body)
                except OSError:
                    pass
                return
        self._send(w.sock, w.send_lock, doc)

    def _send(self, conn, send_lock, doc: dict) -> None:
        try:
            with send_lock:
                send_frame(conn, doc)
        except OSError:
            self._close_conn(conn)     # client went away; nothing to do


def _service_stats_doc(service) -> dict:
    """JSON-able subset of `ServiceStats` for the `stats` op."""
    s = service.stats()
    return {"requests": s.requests, "graphs": s.graphs,
            "hits": s.cache.hits, "misses": s.cache.misses,
            "hit_rate": s.hit_rate, "cache_size": s.cache.size,
            "evictions": s.cache.evictions, "coalesced": s.coalesced,
            "flushes": s.flushes,
            "latency_p50_ms": s.latency_p50_ms,
            "latency_p99_ms": s.latency_p99_ms,
            "buckets": {str(k): {"flushes": b.flushes, "graphs": b.graphs,
                                 "occupancy": b.mean_node_occupancy}
                        for k, b in s.buckets.items()}}
