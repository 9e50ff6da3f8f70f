"""One run of one cell: set-up, the measured window, the traced slice, the
check against the reference, and the result's line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
`BENCHMARK.json` gives it (see `README.md`):

- `configs/<config>.json` (the path in `BENCHMARK.json`'s `configs`):
  the published config, the cut, the departures, and what the driver
  builds the program from (for the LM drivers `port` and `init`);
- `reference/<config>.py`: the plain reference, `forward`, and for the
  yardstick's count of the work `shapes` (`roofline.py`);
- `traffic/<traffic>.json`: the mix, and the driver that runs it;
- `drivers/<driver>.py`: a `Driver(cell, seed, device)` that builds the
  program's state from the seed, with `window`, `ready` and `slice` (the
  traced slice), `release` and `check`;
- `workloads/<cell>.json`: the limits that decide `correct`;
- `metrics/<metric>.py`: a `read(ctx)` per per-layer metric.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from types import SimpleNamespace

import torch

from portbench import roofline, trace
from portbench.compare import verdict

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from a file of the benchmark, by path (names hold '-')."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path}: no such file")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: str, name: str) -> SimpleNamespace:
    """The cell `name` of `root`/BENCHMARK.json with its files."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"there are {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    pb = os.path.join(root, "portbench")
    return SimpleNamespace(
        name=name, entry=w, bench=bench,
        config=load_json(os.path.join(root, conf["file"])),
        traffic=load_json(os.path.join(pb, "traffic", f"{w['traffic']}.json")),
        limits=load_json(os.path.join(pb, "workloads",
                                      f"{name}.json"))["limits"],
        reference_path=os.path.join(pb, "reference", f"{w['config']}.py"),
        per_layer=[m for m in bench["per_layer"]
                   if name in m.get("workloads", [name])])


def loaded_forbidden() -> list[str]:
    """Modules of JAX or of the JAX package (`repro`) in this process,
    compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def finite(x):
    """x, or None where it is missing or not a finite number (JSON)."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def power_limit() -> str | None:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def build(root: str, name: str, seed: int, device):
    """(cell, driver): the cell's driver, which builds the program's state
    from `seed` on `device`, its warm-up done."""
    cell = load_cell(root, name)
    driver = cell.traffic["driver"]
    return cell, load_module(
        os.path.join(root, "portbench", "drivers", f"{driver}.py"),
        f"portbench_driver_{driver}").Driver(cell, seed, device)


def least_seconds(ref, cell, work: list[dict]):
    """The yardstick's least time for the window's work, where the
    reference describes the model's shapes; else None."""
    if not hasattr(ref, "shapes"):
        return None
    return roofline.least_seconds(ref.shapes(cell.config), work)


def run_cell(root: str, name: str, seed: int, seconds: float, trace_on: bool,
             device, t_start: float, log=None) -> dict:
    """One run of cell `name`; returns the result's line as a dict (its
    `checks` last). `t_start` is the process's start on the host clock."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    device = torch.device(device)
    cell, drv = build(root, name, seed, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    win = drv.window(seconds)
    log(f"[window] {win['calls']} calls or steps in {win['seconds']:.6f} s, "
        f"{win['per_call_s'] * 1e3:.6f} ms each; setup_s {setup_s:.6f}; "
        f"{win.get('note', '')}")
    result = {"correct": False, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": {}}
    ref = load_module(cell.reference_path, "portbench_reference")
    if trace_on:
        drv.ready()
        sl, tr = trace.profile(drv.slice) if cuda else \
            (drv.slice(), {"busy_s": 0.0, "window_s": 0.0, "kernels": 0,
                           "device_ops": [], "idle_gaps": []})
        per_call = tr["window_s"] / sl["calls"]
        log(f"[trace] {sl['calls']} calls or steps traced, "
            f"{per_call * 1e3:.6f} ms each against "
            f"{win['per_call_s'] * 1e3:.6f} untraced (overhead "
            f"{(per_call / win['per_call_s'] - 1) * 100:.3f} %); device "
            f"busy {tr['busy_s']:.6f} of {tr['window_s']:.6f} s, "
            f"{tr['kernels']} kernels")
        ctx = {"window": win, "slice": sl, "trace": tr,
               "least_s": least_seconds(ref, cell, win.get("work", []))}
        for m in cell.per_layer:
            value = load_module(
                os.path.join(root, "portbench", "metrics",
                             f"{m['name']}.py"),
                f"portbench_metric_{m['name']}").read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    else:
        units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"]}
        for k, v in win["metrics"].items():
            result["metrics"][k] = {"value": v, "unit": units[k]}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    result["device"] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else "CPU",
        "count": cell.entry["chips"],
        "memory_peak_bytes": torch.cuda.max_memory_allocated(device)
        if cuda else 0}
    if trace_on:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    if cuda:
        result["device"]["power_limit"] = power_limit()
    drv.release()
    t0 = time.perf_counter()
    readings = drv.check(ref, cell.config)
    log(f"[check] reference {time.perf_counter() - t0:.3f} s")
    result["correct"] = verdict(readings, cell.limits)
    result["checks"] = {k: {"value": finite(readings.get(k)), "limit": lim}
                        for k, lim in cell.limits.items()}
    return result
