"""Spans and counters inside the program's model step, off by default.

    tracing.start()
    ...                     # the program runs: spans and counters record
    spans, counters = tracing.stop()

`span(name)` is a context manager around a piece of the step;
`count(name, value)` adds to a counter. While no recording is open, both
return after one module-level check: `span` hands back one shared no-op
context, whose `with ... as s` binds None, and neither reads a clock,
allocates or calls CUDA. A caller whose counter or attributes take work
to build builds them only under `recording()` (or a span bound to
something other than None).

A span records its name, its host interval (`time.perf_counter_ns`), its
parent (the span open around it, by index) and its attributes (the dict
`s.attrs`, empty until the caller fills it), and carries the `step` id
of its root span: the spans of one prefill call or
one decode step share it. `stop()` converts every interval to Unix
nanoseconds through one anchor pair taken at `start()`, the clock of
`torch.profiler`'s records, so that spans and the device trace line up,
and gives each span its self time (its duration less its children's).

A counter's value is a Python int, added at once, or a device tensor,
whose nonzero entries are counted at `stop()`: counting keeps a
reference and launches no kernel and forces no synchronisation inside a
traced slice. Spans nest on one thread (the model step's).
"""
from __future__ import annotations

import time

import torch


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


NOOP = _Noop()


class _Recording:
    def __init__(self):
        p0 = time.perf_counter_ns()
        t = time.time_ns()
        self.anchor = (t, (p0 + time.perf_counter_ns()) // 2)
        self.spans: list[_Span] = []
        self.open: list[_Span] = []
        self.ints: dict[str, int] = {}
        self.tensors: dict[str, list[torch.Tensor]] = {}
        self.roots = 0


_rec: _Recording | None = None


class _Span:
    __slots__ = ("rec", "name", "attrs", "index", "parent", "step", "start",
                 "end")

    def __init__(self, rec: _Recording, name: str):
        self.rec, self.name, self.attrs = rec, name, {}

    def __enter__(self):
        rec = self.rec
        self.index = len(rec.spans)
        if rec.open:
            top = rec.open[-1]
            self.parent, self.step = top.index, top.step
        else:
            self.parent, self.step = None, rec.roots
            rec.roots += 1
        rec.spans.append(self)
        rec.open.append(self)
        self.end = None
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        self.rec.open.pop()
        return None


def span(name: str):
    """A context manager that records `name` while a recording is open;
    `with span(name) as s` binds the span, or None while none is."""
    if _rec is None:
        return NOOP
    return _Span(_rec, name)


def recording() -> bool:
    """Whether a recording is open."""
    return _rec is not None


def count(name: str, value) -> None:
    """Add `value` (an int, or a tensor's nonzero entries) to `name`."""
    if _rec is None:
        return
    if isinstance(value, torch.Tensor):
        _rec.tensors.setdefault(name, []).append(value)
    else:
        _rec.ints[name] = _rec.ints.get(name, 0) + int(value)


def start() -> None:
    """Open a recording (a new one, dropping any left open)."""
    global _rec
    _rec = _Recording()


def stop() -> tuple[list[dict], dict[str, int]]:
    """Close the recording: (spans in start order, counters by name).

    Each span is a dict with `name`, `attrs`, `parent` (index or None),
    `step`, `start_ns` and `end_ns` (Unix ns) and `self_ns`; a span still
    open ends now."""
    global _rec
    rec, _rec = _rec, None
    if rec is None:
        raise RuntimeError("tracing.stop() without tracing.start()")
    now = time.perf_counter_ns()
    unix = rec.anchor[0] - rec.anchor[1]
    out = [{"name": s.name, "attrs": s.attrs, "parent": s.parent,
            "step": s.step, "start_ns": s.start + unix,
            "end_ns": (now if s.end is None else s.end) + unix}
           for s in rec.spans]
    for s in out:
        s["self_ns"] = s["end_ns"] - s["start_ns"]
    for s in out:
        if s["parent"] is not None:
            out[s["parent"]]["self_ns"] -= s["end_ns"] - s["start_ns"]
    counters = dict(rec.ints)
    for name, ts in rec.tensors.items():
        counters[name] = counters.get(name, 0) + sum(
            int(torch.count_nonzero(t)) for t in ts)
    return out, counters
