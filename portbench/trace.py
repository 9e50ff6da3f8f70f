"""The device trace of a bounded slice of a run, and what is read from it.

`profile(fn)` runs `fn()` once under `torch.profiler`, recording CUDA
activity alone (with the host's ops beside, the profiler's
post-processing grows by seconds for every ~15k launches), ended by a
synchronize. From the device's activity records it returns:

- `busy_s`: the union of the intervals in which a kernel, copy or set
  ran on the device; `window_s`: the slice's wall time on the host clock;
- `kernels`: the number of kernel records (copies and sets apart);
- `device_ops`: device seconds by operation name, the ten largest;
- `idle_gaps`: the device's idle gaps summed by the two operations
  around them (what ended before the gap, what started after it), the ten
  largest: a gap before the first decode kernel of a step is the host's
  copy of the tokens and its next launches.
"""
from __future__ import annotations

import time

import torch

TOP = 10


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0].split("<")[0][:48]


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def profile(fn) -> tuple[object, dict]:
    """(fn's result, the slice's reading)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0)
    return out, read(events, window_s)


def read(events: list[tuple[int, int, str]], window_s: float) -> dict:
    """The reading of device records (start ns, end ns, name), sorted."""
    ops: dict[str, float] = {}
    gaps: dict[str, float] = {}
    busy_ns, end, last = 0, None, None
    for start, stop, name in events:
        ops[name] = ops.get(name, 0.0) + (stop - start) * 1e-9
        if end is None or start > end:
            if end is not None:
                key = f"{_short(last)} -> {_short(name)}"
                gaps[key] = gaps.get(key, 0.0) + (start - end) * 1e-9
            busy_ns += stop - start
            end, last = stop, name
        elif stop > end:
            busy_ns += stop - end
            end, last = stop, name

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]

    return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
            "kernels": sum(1 for _, _, n in events if _is_kernel(n)),
            "device_ops": top(ops), "idle_gaps": top(gaps)}
