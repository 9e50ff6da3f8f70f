"""Cost-model serving client (docs/SERVING.md §server).

Synchronous request/response client for `repro_torch.serving.server`: frames a
predict request (graphs as `KernelGraph.to_dict()` payloads), reads the
response, and turns the server's explicit error vocabulary into typed
exceptions. Transient failures — a dropped connection, a corrupt frame,
an `overloaded` shed, a `worker_failure` — are retried with exponential
backoff over a fresh connection (scoring is pure, so resends are
idempotent; a retried graph that was already scored is a cache hit).
`deadline_exceeded` is *not* retried: the caller's latency budget is
gone, retrying would only lie about it.

Import cost matters here: this module (and everything it pulls in) is
numpy+stdlib only, so the load benchmark can fan out client *processes*
that never pay the torch import.

>>> CostModelClient("127.0.0.1", 1, retries=0).retries
0
"""
from __future__ import annotations

import socket
import time
from typing import Sequence

import numpy as np

from repro_torch.core.graph import KernelGraph
from repro_torch.serving.server import FrameError, recv_frame, send_frame


class ClientError(Exception):
    """Base class for serving-client failures."""


class Overloaded(ClientError):
    """Server shed the request at admission (queue full) and retries ran
    out."""


class DeadlineExceeded(ClientError):
    """The request's deadline passed before the server started scoring."""


class WorkerFailure(ClientError):
    """The server's scoring pass died (fault injection / bug) and retries
    ran out."""


class ServerShutdown(ClientError):
    """The server stopped before scoring the request."""


class ProtocolError(ClientError):
    """Undecodable frame, response/request id mismatch, or malformed
    response."""


_RETRYABLE_ERRORS = {"overloaded", "worker_failure"}
_ERROR_TYPES = {"overloaded": Overloaded,
                "deadline_exceeded": DeadlineExceeded,
                "worker_failure": WorkerFailure,
                "shutting_down": ServerShutdown}


class CostModelClient:
    """Retrying synchronous client for one cost-model server.

    Parameters:
      host, port   server address (`CostModelServer.address`)
      timeout_s    socket timeout per send/recv (a hung server surfaces
                   as `ClientError`, never as an indefinite block)
      retries      max *re*-attempts after a retryable failure
      backoff_s    initial backoff; doubles per attempt, capped at
                   `backoff_cap_s` (kept small — the admission queue
                   drains in milliseconds)
    """

    def __init__(self, host: str, port: int, *, timeout_s: float = 10.0,
                 retries: int = 3, backoff_s: float = 0.01,
                 backoff_cap_s: float = 0.1):
        self.host, self.port = host, int(port)
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._sock: socket.socket | None = None
        self._next_id = 0
        self.reconnects = 0            # transport resets survived
        self.retried = 0               # requests that needed a re-attempt

    # -- transport ----------------------------------------------------------
    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port),
                                         timeout=self.timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def _reset(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self.reconnects += 1

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self) -> "CostModelClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request/response core ----------------------------------------------
    def _roundtrip_once(self, doc: dict) -> dict:
        """One framed exchange; raises OSError/FrameError on transport
        trouble (the retry loop owns recovery)."""
        sock = self._connect()
        send_frame(sock, doc)
        resp = recv_frame(sock)
        if resp is None:
            raise FrameError("server closed connection before responding")
        if resp.get("id") != doc["id"]:
            raise FrameError(f"response id {resp.get('id')!r} != request "
                             f"id {doc['id']!r}")
        return resp

    def _call(self, doc: dict) -> dict:
        """Send with retry/backoff; returns the ok response or raises the
        typed error. Non-retryable server errors raise immediately."""
        self._next_id += 1
        doc = dict(doc, id=self._next_id)
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            if attempt:
                self.retried += 1
                time.sleep(min(self.backoff_s * (2 ** (attempt - 1)),
                               self.backoff_cap_s))
            try:
                resp = self._roundtrip_once(doc)
            except FrameError as e:
                self._reset()
                last = ProtocolError(str(e))
                continue
            except (OSError, socket.timeout) as e:
                self._reset()
                last = ClientError(f"transport failure: {e}")
                continue
            if resp.get("ok"):
                return resp
            err = resp.get("error", "unknown")
            exc = _ERROR_TYPES.get(err, ClientError)(
                f"{err}: {resp.get('detail', '')}")
            if err not in _RETRYABLE_ERRORS:
                raise exc
            last = exc
        raise last if last is not None else ClientError("retries exhausted")

    # -- public API ----------------------------------------------------------
    def predict_many(self, graphs: Sequence[KernelGraph], *,
                     deadline_ms: float | None = None) -> np.ndarray:
        """Score a batch of kernels on the server; returns float32 scores
        in input order (bit-identical to in-process scoring — float32
        survives the JSON double round trip exactly)."""
        doc = {"op": "predict",
               "graphs": [g.to_dict() for g in graphs]}
        if deadline_ms is not None:
            doc["deadline_ms"] = float(deadline_ms)
        resp = self._call(doc)
        scores = resp.get("scores")
        if not isinstance(scores, list) or len(scores) != len(graphs):
            raise ProtocolError(f"expected {len(graphs)} scores, got "
                                f"{scores!r}")
        return np.asarray(scores, np.float32)

    def predict(self, graph: KernelGraph, *,
                deadline_ms: float | None = None) -> float:
        return float(self.predict_many([graph], deadline_ms=deadline_ms)[0])

    def inject_fault(self, graphs: Sequence[KernelGraph], mode: str, *,
                     delay_s: float = 0.05,
                     deadline_ms: float | None = None) -> np.ndarray:
        """Predict with a per-request fault attached (the server honors it
        only when constructed with `allow_request_faults=True`). Same
        retry semantics as `predict_many` — the point of most fault tests
        is that this still returns, or raises a *typed* error, never
        hangs."""
        doc = {"op": "predict", "graphs": [g.to_dict() for g in graphs],
               "fault": {"mode": mode, "delay_s": delay_s}}
        if deadline_ms is not None:
            doc["deadline_ms"] = float(deadline_ms)
        resp = self._call(doc)
        return np.asarray(resp["scores"], np.float32)

    def ping(self) -> float:
        """Round-trip liveness probe; returns the server's wall time."""
        return float(self._call({"op": "ping"})["pong"])

    def stats(self) -> dict:
        """Server + service counters (`ServerStats.to_dict` + cache/flush
        stats)."""
        resp = self._call({"op": "stats"})
        return {"server": resp["server"], "service": resp["service"]}

    def snapshot(self, path: str | None = None) -> int:
        """Ask the server to persist its warm cache; returns entry count."""
        doc = {"op": "snapshot"}
        if path is not None:
            doc["path"] = path
        return int(self._call(doc)["entries"])

    def shutdown(self) -> None:
        """Request a graceful server shutdown (acknowledged, then the
        server stops in the background)."""
        self._call({"op": "shutdown"})
        self.close()
