"""The attribution of the second traced slice (`spans.py`) on hand-made
records, the six readers of the program's spans and counters, their
entries in BENCHMARK.json found by name, and the reading's path through
the harness on the CPU (the profiler's records made up from the spans).

    PYTHONPATH=src:. python -m pytest -q portbench/tests
"""
from __future__ import annotations

import json
import os
import time

import pytest

from portbench import harness, spans, trace
from portbench.tests import tiny

PREFILL = ["granite-moe.prefill-4k", "deepseek-v3.prefill-8k",
           "granite-moe.prefill-512"]
DECODE = ["deepseek-v3.decode-b32"]
# name: (unit, better, source, layer, moves, workloads)
SIX = {
    "attn_device_pct.prefill": ("%", "lower", "program_span", "layers",
                                "prefill_tokens_per_s", PREFILL),
    "idle_in_step_pct.prefill": ("%", "lower", "program_span", "device",
                                 "prefill_tokens_per_s", PREFILL),
    "moe_device_pct.decode": ("%", "lower", "program_span", "layers",
                              "decode_tokens_per_s", DECODE),
    "host_step_ms.decode": ("ms", "lower", "program_span", "model step",
                            "itl_p95_ms", DECODE),
    "idle_in_step_pct.decode": ("%", "lower", "program_span", "device",
                                "decode_tokens_per_s", DECODE),
    "moe_weight_use_pct.decode": ("%", "higher", "program_counter", "layers",
                                  "decode_tokens_per_s", DECODE),
}


def _metric(name):
    return harness.load_module(
        os.path.join(tiny.PB, "metrics", f"{name}.py"), f"m_{name}")


def _spans(root):
    """One step's spans as `tracing.stop()` gives them (ns, Unix clock)."""
    rows = [(root, 1100, 1700, None), ("block", 1150, 1600, 0),
            ("attn.core", 1200, 1300, 1), ("ffn.moe", 1350, 1550, 1),
            ("moe.experts", 1400, 1500, 3)]
    out = [{"name": n, "attrs": {}, "parent": p, "step": 0, "start_ns": a,
            "end_ns": b, "self_ns": b - a} for n, a, b, p in rows]
    for s in out:
        if s["parent"] is not None:
            out[s["parent"]]["self_ns"] -= s["end_ns"] - s["start_ns"]
    return out


# device records (start, end, name, correlation id) and launches: k1 runs
# while the host is in ffn.moe but was launched in attn.core; the copy is
# busy time but no kernel; k6 has no launch record
DEVICE = [(1130, 1160, "k5", 5), (1250, 1400, "k1", 1),
          (1400, 1450, "k2", 2), (1500, 1650, "k3", 3),
          (1850, 1900, "Memcpy DtoH (Device -> Pageable)", 4),
          (1900, 1950, "argmax", 7), (1960, 1970, "k6", 6)]
LAUNCHES = {1: 1210, 2: 1360, 3: 1450, 4: 1800, 5: 1120, 7: 1810}
WINDOW = (1000, 2000)
COUNTERS = {"moe.experts_hit": 5, "moe.experts_read": 8}


def _reading(root):
    r = spans.attribute(_spans(root), COUNTERS, DEVICE, LAUNCHES, WINDOW)
    # the third slice's (no profiler): three roots, 0.4, 0.5 and 0.9 ms
    r["plain"] = {"calls": 3, "window_s": 2e-3,
                  "roots": {root: [4e-4, 5e-4, 9e-4]}}
    return r


@pytest.mark.parametrize("root", ["lm.prefill", "lm.decode"])
def test_attribution_by_correlation_id_and_idle_split(root):
    r = _reading(root)
    ns = 1e-9
    assert r["window_s"] == pytest.approx(1000 * ns, abs=1e-15)
    assert r["busy_s"] == pytest.approx(490 * ns, abs=1e-15)
    assert r["kernel_s"] == pytest.approx(440 * ns, abs=1e-15)
    assert r["unlaunched_s"] == pytest.approx(10 * ns, abs=1e-15)
    want = {root: (1, 30, 380), "block": (0, 0, 350),
            "attn.core": (1, 150, 150), "ffn.moe": (1, 50, 200),
            "moe.experts": (1, 150, 150)}
    for name, (kernels, self_ns, incl_ns) in want.items():
        e = r["names"][name]
        assert e["kernels"] == kernels and e["calls"] == 1
        assert e["device_s"] == pytest.approx(self_ns * ns, abs=1e-15)
        assert e["device_in_s"] == pytest.approx(incl_ns * ns, abs=1e-15)
    assert r["outside"]["kernels"] == 1
    assert r["outside"]["device_s"] == pytest.approx(50 * ns, abs=1e-15)
    idle = {root: 80, "block": 40, "attn.core": 50, "ffn.moe": 0,
            "moe.experts": 50}
    for name, v in idle.items():
        assert r["names"][name]["idle_s"] == pytest.approx(v * ns, abs=1e-15)
    assert r["outside"]["idle_s"] == pytest.approx(290 * ns, abs=1e-15)
    assert r["idle_in"] == pytest.approx({root: 220 * ns}, abs=1e-15)
    assert r["names"]["block"]["self_s"] == pytest.approx(150 * ns)
    assert spans.idle_by_span(r)[0] == [spans.OUTSIDE, r["outside"]["idle_s"]]

    # in step plus outside the program is `device_idle_pct`'s idle
    tr = trace.read(sorted((a, b, n) for a, b, n, _ in DEVICE),
                    r["window_s"])
    idle_pct = _metric(f"device_idle_pct.{root[3:]}").read({"trace": tr})
    in_step = spans.idle_in_step(r, root)
    outside = 100.0 * r["outside"]["idle_s"] / r["window_s"]
    assert in_step + outside == pytest.approx(idle_pct, abs=1e-9)


@pytest.mark.parametrize("root", ["lm.prefill", "lm.decode"])
def test_each_reader_on_a_made_reading(root):
    r = _reading(root)
    ctx = {"spans": r, "counters": r["counters"]}
    kind = root[3:]
    got = {name: _metric(name).read(ctx) for name in SIX}
    want = {"attn_device_pct": 100.0 * 150 / 440,
            "idle_in_step_pct": 22.0, "moe_device_pct": 100.0 * 200 / 440,
            "host_step_ms": 0.5, "moe_weight_use_pct": 62.5}
    for name, value in got.items():
        base, k = name.split(".")
        if k != kind:
            assert value is None, name
        else:
            assert value == pytest.approx(want[base], rel=1e-12), name
    # an older program: no reading, nothing read
    assert all(_metric(n).read({"spans": None, "counters": None}) is None
               for n in SIX)


def test_device_records_before_their_launches_move_to_them():
    """A profiled run whose device records all read 60 ns early (the earliest
    relative to its launch, k5, then 50 ns before it) is read as the
    records moved 50 ns later: 10 ns earlier than the true ones."""
    early = [(a - 60, b - 60, n, c) for a, b, n, c in DEVICE]
    want = [(a - 10, b - 10, n, c) for a, b, n, c in DEVICE]
    got = spans.attribute(_spans("lm.decode"), COUNTERS, early, LAUNCHES,
                          WINDOW)
    ref = spans.attribute(_spans("lm.decode"), COUNTERS, want, LAUNCHES,
                          WINDOW)
    assert got["clock_shift_s"] == pytest.approx(50e-9, abs=1e-15)
    assert ref["clock_shift_s"] == 0.0
    got.pop("clock_shift_s"), ref.pop("clock_shift_s")
    assert got == ref
    assert _reading("lm.decode")["clock_shift_s"] == 0.0


def test_segments_follow_the_innermost_open_span():
    s = _spans("lm.decode")
    starts, inner = spans._segments(s, *WINDOW)
    assert starts == [1000, 1100, 1150, 1200, 1300, 1350, 1400, 1500, 1550,
                      1600, 1700]
    assert inner == [None, 0, 1, 2, 1, 3, 4, 3, 1, 0, None]


def test_the_six_metrics_are_found_by_name():
    with open(os.path.join(tiny.REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"] for w in bench["workloads"]}
    for name, (unit, better, source, layer, moves, work) in SIX.items():
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
                m["workloads"]) == (unit, better, source, layer, moves, work)
        assert set(work) <= cells
        assert callable(_metric(name).read)
    assert list(entries)[-6:] == list(SIX)


def _made_up_profile(fn, tracing):
    """`spans.profile` on the CPU: fn() with the program's spans recorded,
    and one made-up kernel a span, launched at its start and running half
    of it."""
    tracing.start()
    w0 = time.time_ns()
    out = fn()
    w1 = time.time_ns()
    rec, counters = tracing.stop()
    device = [(s["start_ns"], (s["start_ns"] + s["end_ns"]) // 2, "k", i)
              for i, s in enumerate(rec)]
    launches = {i: s["start_ns"] for i, s in enumerate(rec)}
    return out, {"spans": rec, "counters": counters, "device": device,
                 "launches": launches, "window": (w0, w1)}


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_second_slice_through_the_harness(tmp_path, monkeypatch, cell):
    """The readers find the harness's driver, run the second slice once
    and read the program's spans and counters; nothing without a card."""
    r = tiny.root(tmp_path, "float32")
    res = harness.run_cell(r, cell, 2 ** 31 + 5, 0.3, True, "cpu",
                           time.perf_counter(), log=lambda *a: None)
    assert res["correct"] and not set(SIX) & set(res["metrics"])

    runs, lines = [], []

    def counting(fn, tracing):
        runs.append(1)
        return _made_up_profile(fn, tracing)

    monkeypatch.setattr(spans, "profile", counting)
    monkeypatch.setattr(spans, "_on_card", lambda device: True)
    res = harness.run_cell(r, cell, 2 ** 31 + 5, 0.3, True, "cpu",
                           time.perf_counter(), log=lines.append)
    assert res["correct"], res["checks"]
    kind = "decode" if "decode" in cell else "prefill"
    want = {n for n in SIX if n.endswith(kind)}
    assert want <= set(res["metrics"]) and len(runs) == 1
    m = {n: res["metrics"][n]["value"] for n in want}
    for n, v in m.items():
        assert res["metrics"][n]["unit"] == SIX[n][0]
        if n != "host_step_ms.decode":
            assert 0.0 <= v <= 100.0, (n, v)
    if kind == "decode":
        assert m["host_step_ms.decode"] > 0
        assert 0 < m["moe_weight_use_pct.decode"] <= 100
    else:
        assert m["attn_device_pct.prefill"] > 0
    assert any(x.startswith("[spans] idle_by_span") for x in lines)
    assert any(x.startswith("[spans] second slice") for x in lines)
    assert any(x.startswith("[spans] third slice") for x in lines)


def test_the_harness_frame_holds_what_the_readers_take():
    """`spans.py` reads the driver, the device and the log from
    `harness.run_cell`'s locals: renaming one breaks this test."""
    assert set(spans.FRAME) <= set(harness.run_cell.__code__.co_varnames)


def test_reading_outside_the_harness_fails_loudly():
    """A reader called where no frame holds its `ctx` with the harness's
    locals raises instead of reading nothing."""
    ctx = {"window": {}, "slice": {}, "trace": {}}
    with pytest.raises(RuntimeError, match="run_cell"):
        spans.reading(ctx)
    drv = device = "stand-in"            # a frame without `log`
    with pytest.raises(RuntimeError, match="run_cell"):
        spans.reading(ctx)
    assert (drv, device) and "spans" not in ctx


def test_the_third_slice_times_root_spans_without_the_profiler():
    from repro_torch import tracing

    def fn():
        for step in range(3):
            with tracing.span("lm.decode"):
                time.sleep(0.001 * (step + 1))
        return {"calls": 3}

    p = spans.unprofiled(fn, tracing)
    assert p["calls"] == 3 and not tracing.recording()
    got = p["roots"]["lm.decode"]
    assert len(got) == 3 and all(g >= 0.001 * (i + 1)
                                 for i, g in enumerate(got))
    assert p["window_s"] >= sum(got)
