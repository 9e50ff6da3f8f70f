"""Asynchronous input pipeline: encode batches ahead of the train step.

Counterpart of `repro.data.prefetch`. Host-side feature encoding and the
device step are serialized in a naive training loop — the card idles
while Python encodes the next batch. `Prefetcher` wraps any sampler
exposing ``batch(step) -> batch`` (both `repro_torch.data.sampler`
samplers qualify, including over a `repro_torch.data.store.
StreamingCorpus` or one of its `.shard(idx, num)` worker views, where the
worker thread also absorbs shard decode latency) and runs it on a
background thread, keeping a bounded queue of ready batches so encoding
of step k+1 overlaps the device work of step k.

Guarantees (DESIGN.md §9):

* **Deterministic** — the worker calls the wrapped sampler with exactly the
  step sequence the consumer asks for, so the delivered stream is
  byte-identical to calling ``sampler.batch(step)`` synchronously. Both
  samplers are pure functions of (seed, step, host), so this also holds
  across restarts.
* **Random access degrades gracefully** — the queue is filled for the
  sequential ``start_step, start_step+1, ...`` pattern the trainer uses; a
  seek (``batch(s)`` for any other step, e.g. after checkpoint resume)
  deterministically restarts the worker at ``s``.
* **Clean shutdown** — ``close()`` (or the context manager / GC finalizer)
  stops the worker promptly even if it is blocked on a full queue; worker
  exceptions surface on the consumer's next ``batch()`` call.
* **Optional device transfer overlap** — with ``device=``, the worker
  also moves the encoded graph arrays to that device: on a CUDA device
  it pins them and copies them with ``non_blocking=True`` on a side
  stream of its own, and records an event after the copies. The consumer
  makes its current stream wait on that event, and `record_stream`s the
  copied tensors on it, so the caching allocator cannot hand their
  memory out again before the consumer's work on them is done. On the
  CPU the arrays become tensors, with no copy.

>>> class Doubler:
...     def batch(self, step):
...         return step * 2
>>> with Prefetcher(Doubler(), depth=2) as p:
...     [p.batch(s) for s in (0, 1, 2)]   # sequential: served from queue
[0, 2, 4]
>>> p = Prefetcher(Doubler(), depth=2, start_step=5)
>>> p.batch(5), p.batch(0), p.batch(1)    # seek restarts deterministically
(10, 0, 2)
>>> p.close()
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import weakref

import numpy as np
import torch

_PUT_POLL_S = 0.05       # how often a blocked worker re-checks the stop flag


class _WorkerError:
    """Wrapper marking an exception raised inside the worker thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclasses.dataclass
class _OnDevice:
    """A batch whose graph arrays were copied on the worker's side
    stream: `ready` is recorded after the copies (None on the CPU)."""
    batch: object
    tensors: list
    ready: torch.cuda.Event | None


def _copy_tree(a, device: torch.device, out: list):
    """Numpy leaves of (nested) batch dataclasses → tensors on `device`;
    every copied tensor is appended to `out`."""
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _copy_tree(getattr(a, f.name), device, out)
            for f in dataclasses.fields(a)})
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    out.append(t)
    return t


def _device_put_batch(batch, device: torch.device,
                      stream: torch.cuda.Stream | None) -> _OnDevice:
    """Move the batch's graph arrays to `device`; other fields (targets,
    masks) stay host-side — the trainer converts them per step. On a
    CUDA device the copies run on `stream`."""
    has_graphs = dataclasses.is_dataclass(batch) and hasattr(batch, "graphs")
    tensors: list = []
    if stream is None:
        graphs = _copy_tree(batch.graphs if has_graphs else batch, device,
                            tensors)
        ready = None
    else:
        with torch.cuda.device(device), torch.cuda.stream(stream):
            graphs = _copy_tree(batch.graphs if has_graphs else batch,
                                device, tensors)
            ready = torch.cuda.Event()
            ready.record(stream)
    out = dataclasses.replace(batch, graphs=graphs) if has_graphs else graphs
    return _OnDevice(out, tensors, ready)


def _worker_loop(sampler, device: torch.device | None, q: queue.Queue,
                 stop: threading.Event, step: int) -> None:
    """Worker body (module-level so the thread never references the
    Prefetcher — otherwise a live worker would pin the wrapper and its GC
    finalizer could never run)."""
    stream = None
    while not stop.is_set():
        try:
            batch = sampler.batch(step)
            if device is not None:
                if device.type == "cuda" and stream is None:
                    stream = torch.cuda.Stream(device)
                batch = _device_put_batch(batch, device, stream)
            item = (step, batch)
        except BaseException as exc:                      # noqa: BLE001
            item = (step, _WorkerError(exc))
        while not stop.is_set():
            try:
                q.put(item, timeout=_PUT_POLL_S)
                break
            except queue.Full:
                continue
        if isinstance(item[1], _WorkerError):
            return
        step += 1


def _shutdown(state: dict) -> None:
    """Stop a worker (shared by close() and the GC finalizer, so it must
    not reference the Prefetcher): set the stop flag, drain the queue to
    unblock a full `put`, join."""
    stop, q, thread = state["stop"], state["queue"], state["thread"]
    state["stop"] = state["queue"] = state["thread"] = None
    if stop is None:
        return
    stop.set()
    if q is not None:
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
    if thread is not None and thread.is_alive():
        thread.join(timeout=5.0)


class Prefetcher:
    """Background-thread prefetch wrapper around ``sampler.batch(step)``.

    ``depth`` bounds how many encoded batches may be queued ahead (the
    host-memory budget). ``device`` (None: stay on the host) is where
    the worker also copies each batch's graph arrays. The wrapper is
    itself a sampler (same ``batch`` contract), so it drops into
    `CostModelTrainer` unchanged — the trainer enables it via
    ``TrainerConfig.prefetch`` (and ``prefetch_device_put``, which
    passes the trainer's device).
    """

    def __init__(self, sampler, *, depth: int = 2, start_step: int = 0,
                 device: str | torch.device | None = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.sampler = sampler
        self.depth = int(depth)
        self.device = None if device is None else torch.device(device)
        if self.device is not None and self.device.type == "cuda" \
                and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # worker state lives in a dict shared with the finalizer so neither
        # holds a reference back to `self` (which would defeat GC cleanup)
        self._state: dict = {"stop": None, "queue": None, "thread": None}
        self._next_step: int | None = None
        self._finalizer = weakref.finalize(self, _shutdown, self._state)
        self._restart(start_step)

    def _restart(self, step: int) -> None:
        _shutdown(self._state)
        q = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        thread = threading.Thread(
            target=_worker_loop,
            args=(self.sampler, self.device, q, stop, step),
            name=f"prefetch-{step}", daemon=True)
        self._state.update(stop=stop, queue=q, thread=thread)
        self._next_step = step
        thread.start()

    # --- consumer API ------------------------------------------------------
    def batch(self, step: int):
        """The wrapped sampler's batch for `step` — from the queue when the
        access is sequential, via a deterministic worker restart when not.
        A batch copied to a CUDA device is ready on the caller's current
        stream of that device."""
        if self._state["queue"] is None or step != self._next_step:
            self._restart(step)
        got_step, payload = self._state["queue"].get()
        if got_step != step:
            raise RuntimeError(f"prefetch stream skew: {got_step} != {step}")
        if isinstance(payload, _WorkerError):
            _shutdown(self._state)     # worker exited; next call restarts
            self._next_step = None
            raise payload.exc
        self._next_step = step + 1
        if isinstance(payload, _OnDevice):
            if payload.ready is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(payload.ready)
                for t in payload.tensors:
                    t.record_stream(consumer)
            return payload.batch
        return payload

    def close(self) -> None:
        """Stop the worker and release the queue. Idempotent."""
        _shutdown(self._state)
        self._next_step = None

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
