"""The program's spans and counters over a second traced slice, and what is
read from them: the per-layer metrics of source `program_span` and
`program_counter`.

With `--trace 1` the harness profiles one slice (`trace.py`) and computes
`breakdown` and the metrics of source `device_trace` from it. `reading(ctx)`
then runs, at the first metric that asks, a second slice of the same
calls or steps: `drv.ready()`, then `drv.slice()` under the profiler's CUDA
activity alone (as `trace.profile`), with `repro_torch.tracing` recording
around it; then a third slice, `drv.ready()` and `drv.slice()` with the
recording on and no profiler, whose root spans give the host's own step
time (the profiler's launch tracing lengthens every launch). It keeps the
result in `ctx` (`ctx["spans"]`, `ctx["counters"]`) for the other
metrics, and prints `[spans]` lines to standard error.

From the second slice's records:

- each kernel record goes to the innermost program span whose host
  interval holds the start of its launch record (the host's CUDA call
  with the same correlation id, `cudaLaunchKernel` and kin); a launch
  in no span goes to `OUTSIDE`: the driver's argmax, the served tokens'
  write and the copy to the host;
- each idle interval of the device inside the slice's window (host clock,
  synchronize included, as `device_idle_pct`) goes to the innermost span
  open on the host during it, split where that changes, or to `OUTSIDE`.

The profiler puts device records on the host clock by one conversion
each time it starts, and on the card some profiled runs (3 of 42 in one
check) had every device record 0.07-0.2 ms early, kernels before their
own launch records. Before the idle split the device records move later
by the largest such lead (`clock_shift_s`), so that none starts before
its launch; the rest of the error is the launch latency, 2-9 us in the
runs without a lead.

The harness hands a metric `ctx` alone: the driver for the second slice is
the `drv` of the harness frame that holds this very `ctx`
(`harness.run_cell`, its locals `ctx`, `drv`, `device` and `log`). Without
a card or the program's `repro_torch.tracing` (an older program),
`reading` gives None and the metrics read nothing; without that frame it
raises, so that a harness whose locals moved fails instead of reading
nothing.
"""
from __future__ import annotations

import bisect
import importlib
import json
import statistics
import sys
import time

from portbench import trace

OUTSIDE = "(outside the program)"
# what `_second_slice` takes from `harness.run_cell`'s frame
FRAME = ("ctx", "drv", "device", "log")


def _caller(ctx: dict):
    """The locals of the harness frame that holds `ctx`, or None."""
    f = sys._getframe(1)
    while f is not None:
        loc = f.f_locals
        if loc.get("ctx") is ctx and all(k in loc for k in FRAME):
            return loc
        f = f.f_back
    return None


def reading(ctx: dict):
    """The second slice's reading (run once, then kept in `ctx`), or None."""
    if "spans" not in ctx:
        ctx["spans"], ctx["counters"] = _second_slice(ctx)
    return ctx["spans"]


def _on_card(device) -> bool:
    return getattr(device, "type", None) == "cuda"


def _second_slice(ctx: dict):
    try:
        tracing = importlib.import_module("repro_torch.tracing")
    except ModuleNotFoundError:          # a program without spans
        return None, None
    loc = _caller(ctx)
    if loc is None:
        raise RuntimeError(
            "spans.reading: no caller frame holds this ctx with the locals "
            f"{', '.join(FRAME)} (harness.run_cell's); the program's spans "
            "cannot be read")
    if not _on_card(loc["device"]):
        return None, None
    log, drv = loc["log"], loc["drv"]
    drv.ready()
    sl, rec = profile(drv.slice, tracing)
    out = attribute(**rec)
    out["calls"] = sl["calls"]
    drv.ready()
    out["plain"] = unprofiled(drv.slice, tracing)
    for line in lines(out, ctx):
        log(line)
    return out, rec["counters"]


def unprofiled(fn, tracing) -> dict:
    """`fn()` once with `tracing` recording and no profiler, ended by a
    synchronize where there is a card: its calls or steps, its wall
    seconds and each root span's host seconds, {name: [seconds]}."""
    import torch

    card = torch.cuda.is_available()
    if card:
        torch.cuda.synchronize()
    tracing.start()
    t0 = time.perf_counter()
    sl = fn()
    if card:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    spans, _ = tracing.stop()
    roots: dict[str, list[float]] = {}
    for s in spans:
        if s["parent"] is None:
            roots.setdefault(s["name"], []).append(
                (s["end_ns"] - s["start_ns"]) * 1e-9)
    return {"calls": sl["calls"], "window_s": secs, "roots": roots}


def profile(fn, tracing) -> tuple[object, dict]:
    """(fn's result, its records): `fn()` once under the profiler's CUDA
    activity with `tracing` recording, ended by a synchronize."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        tracing.start()
        w0 = time.time_ns()
        out = fn()
        torch.cuda.synchronize()
        w1 = time.time_ns()
    spans, counters = tracing.stop()     # its counters' reductions untraced
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.duration_ns() > 0:
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.name(), e.correlation_id()))
        elif e.name().startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
    return out, {"spans": spans, "counters": counters, "device": device,
                 "launches": launches, "window": (w0, w1)}


def _segments(spans: list[dict], w0: int, w1: int):
    """The host timeline from w0 to w1 as (starts, innermost span index or
    None): the innermost open span is spans[inner[i]] from starts[i] to
    starts[i + 1] (or w1)."""
    events = sorted([(s["start_ns"], 1, i) for i, s in enumerate(spans)]
                    + [(s["end_ns"], 0, i) for i, s in enumerate(spans)])
    starts, inner, stack = [w0], [None], []
    for t, opening, i in events:
        if opening:
            stack.append(i)
        elif stack[-1] == i:
            stack.pop()
        else:
            stack.remove(i)
        t = min(max(t, w0), w1)
        top = stack[-1] if stack else None
        if t == starts[-1]:
            inner[-1] = top
        elif top != inner[-1]:
            starts.append(t)
            inner.append(top)
    return starts, inner


def _busy(device: list, w0: int, w1: int) -> list[tuple[int, int]]:
    """The union of the device records' intervals, clipped to [w0, w1]."""
    out: list[list[int]] = []
    for a, b, *_ in sorted(device):
        a, b = max(a, w0), min(b, w1)
        if a >= b:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def attribute(spans: list[dict], counters: dict, device: list,
              launches: dict, window: tuple[int, int]) -> dict:
    """The reading of one slice's records: `spans` as `tracing.stop()`
    gives them, `device` records (start ns, end ns, name, correlation id),
    `launches` {correlation id: start ns} and the slice's `window` (Unix
    ns)."""
    w0, w1 = window
    lead = max([launches[c] - a for a, _, _, c in device if c in launches],
               default=0)
    if lead > 0:
        device = [(a + lead, b + lead, n, c) for a, b, n, c in device]
    root = []
    for s in spans:
        root.append(root[s["parent"]] if s["parent"] is not None
                    else s["name"])
    names: dict[str, dict] = {}

    def entry(name):
        return names.setdefault(name, {
            "calls": 0, "host_s": 0.0, "self_s": 0.0, "kernels": 0,
            "device_s": 0.0, "device_in_s": 0.0, "idle_s": 0.0})

    for s in spans:
        e = entry(s["name"])
        e["calls"] += 1
        e["host_s"] += (s["end_ns"] - s["start_ns"]) * 1e-9
        e["self_s"] += s["self_ns"] * 1e-9
    outside = {"kernels": 0, "device_s": 0.0, "idle_s": 0.0}
    starts, inner = _segments(spans, w0, w1)

    kernel_s = unlaunched_s = 0.0
    for a, b, name, corr in device:
        if not trace._is_kernel(name):
            continue
        secs = (b - a) * 1e-9
        kernel_s += secs
        t = launches.get(corr)
        if t is None:
            unlaunched_s += secs
            continue
        i = inner[bisect.bisect_right(starts, t) - 1] \
            if w0 <= t < w1 else None
        e = outside if i is None else names[spans[i]["name"]]
        e["kernels"] += 1
        e["device_s"] += secs
        seen = set()                    # each name once up the chain
        while i is not None:
            n = spans[i]["name"]
            if n not in seen:
                seen.add(n)
                names[n]["device_in_s"] += secs
            i = spans[i]["parent"]

    busy = _busy(device, w0, w1)
    idle_in: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    j = 0
    for a, b in zip(edges[::2], edges[1::2]):          # the idle intervals
        while j + 1 < len(starts) and starts[j + 1] <= a:
            j += 1
        k = j
        while a < b:
            end = min(b, starts[k + 1]) if k + 1 < len(starts) else b
            secs = (end - a) * 1e-9
            i = inner[k]
            if i is None:
                outside["idle_s"] += secs
            else:
                names[spans[i]["name"]]["idle_s"] += secs
                idle_in[root[i]] = idle_in.get(root[i], 0.0) + secs
            a = end
            k += 1
    roots: dict[str, list[float]] = {}
    for s in spans:
        if s["parent"] is None:
            roots.setdefault(s["name"], []).append(
                (s["end_ns"] - s["start_ns"]) * 1e-9)
    return {"window_s": (w1 - w0) * 1e-9,
            "clock_shift_s": max(lead, 0) * 1e-9,
            "busy_s": sum(b - a for a, b in busy) * 1e-9,
            "kernel_s": kernel_s, "unlaunched_s": unlaunched_s,
            "names": names, "outside": outside, "idle_in": idle_in,
            "roots": roots, "counters": dict(counters)}


def device_share(r: dict, name: str, root: str):
    """% of the slice's kernel device seconds launched inside `name` (or
    its children), where a `root` span ran; else None."""
    if r is None or root not in r["roots"] or r["kernel_s"] <= 0:
        return None
    return 100.0 * r["names"].get(name, {}).get("device_in_s", 0.0) \
        / r["kernel_s"]


def idle_in_step(r: dict, root: str):
    """% of the slice's wall time the device idled while a `root` span was
    open on the host; None where none ran."""
    if r is None or root not in r["roots"] or r["window_s"] <= 0:
        return None
    return 100.0 * r["idle_in"].get(root, 0.0) / r["window_s"]


def idle_by_span(r: dict) -> list:
    """[[span name, idle seconds]], the ten largest, `OUTSIDE` among them."""
    idle = {n: e["idle_s"] for n, e in r["names"].items() if e["idle_s"]}
    if r["outside"]["idle_s"]:
        idle[OUTSIDE] = r["outside"]["idle_s"]
    return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])
            [:trace.TOP]]


def lines(r: dict, ctx: dict) -> list[str]:
    """The `[spans]` lines: the cost of tracing, one line a span name, the
    attribution's coverage and `idle_by_span`."""
    first = ctx["trace"]["window_s"] / ctx["slice"]["calls"]
    per_call = r["window_s"] / r["calls"]
    cost = f"{(per_call / first - 1) * 100:.3f} %" if first > 0 else "-"
    out = [f"[spans] second slice: {r['calls']} calls or steps, "
           f"{per_call * 1e3:.6f} ms each against {first * 1e3:.6f} in the "
           f"first (tracing on: {cost}); device busy {r['busy_s']:.6f} of "
           f"{r['window_s']:.6f} s; device records moved "
           f"{r['clock_shift_s'] * 1e6:.3f} us later to their launches"]
    for n, e in sorted(r["names"].items(), key=lambda kv: -kv[1]["host_s"]):
        out.append(
            f"[spans] {n}: calls {e['calls']} host ms {e['host_s'] * 1e3:.4f}"
            f" self {e['self_s'] * 1e3:.4f} kernels {e['kernels']} device ms"
            f" {e['device_s'] * 1e3:.4f} (with children "
            f"{e['device_in_s'] * 1e3:.4f}) idle ms {e['idle_s'] * 1e3:.4f}")
    o = r["outside"]
    out.append(f"[spans] {OUTSIDE}: kernels {o['kernels']} device ms "
               f"{o['device_s'] * 1e3:.4f} idle ms {o['idle_s'] * 1e3:.4f}")
    k = r["kernel_s"] or 1.0
    in_spans = sum(e["device_s"] for e in r["names"].values())
    under = {n: r["names"][n]["device_in_s"] / k * 100 for n in r["roots"]}
    out.append(
        f"[spans] kernel device time {r['kernel_s']:.6f} s: "
        f"{in_spans / k * 100:.4f} % in spans "
        f"({', '.join(f'{n} {v:.4f} %' for n, v in under.items())}), "
        f"{o['device_s'] / k * 100:.4f} % outside the program, "
        f"{r['unlaunched_s'] / k * 100:.4f} % without a launch record")
    idle = r["window_s"] - r["busy_s"]
    out.append(
        f"[spans] idle {idle:.6f} s of {r['window_s']:.6f}: "
        + ", ".join(f"in {n} {v:.6f} s" for n, v in r["idle_in"].items())
        + f", outside the program {o['idle_s']:.6f} s; counters "
        + json.dumps(r["counters"]))
    out.append("[spans] idle_by_span " + json.dumps(idle_by_span(r)))
    steps = {n: statistics.median(v) * 1e3 for n, v in r["roots"].items()}
    out.append("[spans] median host ms a root span, profiled "
               + json.dumps(steps))
    p = r.get("plain")
    if p:
        untraced = ctx["window"]["per_call_s"]
        each = p["window_s"] / p["calls"]
        steps = {n: statistics.median(v) * 1e3
                 for n, v in p["roots"].items()}
        out.append(
            f"[spans] third slice, recording on and no profiler: "
            f"{p['calls']} calls or steps, {each * 1e3:.6f} ms each against "
            f"{untraced * 1e3:.6f} in the untraced window (tracing on: "
            f"{(each / untraced - 1) * 100:.3f} %); median host ms a root "
            f"span " + json.dumps(steps))
    return out
