"""musicgen-large's files of the benchmark on the CPU at a small size
(d 64, 2 layers, 4 heads, 4 codebooks of 32 codes, text states of width
24 and length 8): the benchmark's reference against the tests' copy
(`tests/musicgen_reference.py`), both drivers' windows and checks, the
control, faults of the timed path, and that every file the two cells
use is found by its name with no other file edited.

    PYTHONPATH=src:. python -m pytest -q -p no:cacheprovider portbench/tests
"""
from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
import time

import pytest
import torch

from portbench import control, harness
from portbench.compare import verdict
from portbench.tests import tiny

REPO = tiny.REPO
MUSICGEN = {
    "hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 2,
    "ffn_dim": 128, "num_codebooks": 4, "vocab_size": 32,
    "layer_norm_eps": 1e-5, "text_len": 8,
    "departures": {},
    "port": {"name": "musicgen-tiny", "family": "audio", "d_model": 64,
             "vocab_size": 32, "num_heads": 4, "num_kv_heads": 4,
             "head_dim": 16, "d_ff": 128, "stacks": [[["attn+mlp"], 2]],
             "norm": "layer", "mlp": "gelu", "positions": "sinusoidal",
             "num_codebooks": 4, "cross_attn_dim": 24,
             "use_pallas_attn": True, "norm_eps": 1e-5, "block_kv": 4,
             "dtype": "float32"},
    # wider than the real cells' 0.02, so that the tiny model's logits
    # spread as a published width's do (a served code altered reads a
    # gap well past the real limit)
    "init": {"std": 0.05, "ones": ["scale"], "zeros": ["bias"]},
}
TRAFFIC = {
    "tiny.codes.prefill": {"driver": "prefill_codes", "batch": 2,
                           "prompt_len": 16, "text_len": 8,
                           "trace_calls": 1},
    "tiny.codes.decode": {"driver": "decode_codes", "batch": 4,
                          "prompt_len": 1, "text_len": 8,
                          "decode_frames": 6, "check_sequences": 2,
                          "trace_steps": 2},
}
# tiny cell -> (traffic, the real cell whose limits and metrics it takes)
CELLS = {
    "tiny.musicgen.prefill": ("tiny.codes.prefill",
                              "musicgen-large.prefill-2k"),
    "tiny.musicgen.decode": ("tiny.codes.decode",
                             "musicgen-large.decode-b64"),
}
# every file of the benchmark that the two cells add
NEW = ["codes.py", "configs/musicgen-large.json",
       "reference/musicgen-large.py", "drivers/prefill_codes.py",
       "drivers/decode_codes.py",
       "traffic/codes.prefill.b8.s2048.t64.json",
       "traffic/codes.decode.b64.t64.n500.json",
       "workloads/musicgen-large.prefill-2k.json",
       "workloads/musicgen-large.decode-b64.json",
       "metrics/xattn_device_pct.prefill.py",
       "metrics/xattn_device_pct.decode.py"]


def config(dtype: str = "float32") -> dict:
    c = copy.deepcopy(MUSICGEN)
    c["port"]["dtype"] = dtype
    return c


def root(tmp, dtype: str = "float32") -> str:
    """`tiny.root` with the tiny musicgen configuration and its two cells,
    which hold the real cells' limits and are listed where they are."""
    r = tiny.root(tmp, dtype)
    pb = os.path.join(r, "portbench")
    with open(os.path.join(pb, "configs", "tiny-musicgen-large.json"),
              "w") as f:
        json.dump(config(dtype), f)
    with open(os.path.join(r, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "musicgen-large", "source": "tiny",
                             "reduced": [], "why": "tiny",
                             "file": "portbench/configs/"
                                     "tiny-musicgen-large.json"})
    for cell, (traf, real) in CELLS.items():
        with open(os.path.join(pb, "traffic", f"{traf}.json"), "w") as f:
            json.dump(TRAFFIC[traf], f)
        shutil.copy(os.path.join(pb, "workloads", f"{real}.json"),
                    os.path.join(pb, "workloads", f"{cell}.json"))
        bench["workloads"].append({"name": cell, "config": "musicgen-large",
                                   "traffic": traf, "chips": 1,
                                   "why": "tiny"})
        for m in bench["per_layer"] + bench["end_to_end"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    with open(os.path.join(r, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return r


def _reference():
    return harness.load_module(
        os.path.join(tiny.PB, "reference", "musicgen-large.py"),
        "portbench_reference_musicgen")


def _redraw_norms(tree, gen) -> None:
    """LayerNorm's weights 1 + N(0, 0.1) and biases N(0, 0.1), in place."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in ("scale", "bias") and isinstance(v, torch.Tensor):
                v.copy_((k == "scale") + 0.1 * torch.randn(v.shape,
                                                           generator=gen))
            else:
                _redraw_norms(v, gen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _redraw_norms(v, gen)


def _params(seed=0):
    """The benchmark's weights of the tiny config, its norms drawn too, so
    that both copies of the reference read them."""
    from repro_torch.models import lm

    from portbench import port_lm, weights
    cfg = port_lm.model_config(MUSICGEN["port"])
    made = weights.make(lm.init_abstract(cfg), MUSICGEN["init"], seed, "cpu")
    _redraw_norms(made, torch.Generator().manual_seed(seed + 1))
    return made


def test_the_benchmark_reference_equals_the_tests_copy():
    tests_ref = harness.load_module(
        os.path.join(REPO, "tests", "musicgen_reference.py"),
        "tests_musicgen_reference")
    params = _params()
    gen = torch.Generator().manual_seed(3)
    B, K, S = 3, 4, 11
    codes = torch.randint(0, 33, (B, K, S), generator=gen)
    text = torch.randn(B, 8, 24, generator=gen)
    rows = torch.arange(B * S)
    got, got_caches = _reference().forward(params, MUSICGEN, codes, text,
                                           rows)
    want, want_caches = tests_ref.forward(params, codes, text)
    torch.testing.assert_close(got, want.reshape(B * S, K, -1), rtol=1e-5,
                               atol=1e-5)
    assert len(got_caches) == len(want_caches) == 2
    for g, w in zip(got_caches, want_caches):
        assert set(g) == set(w) == {"k", "v", "xk", "xv"}
        for k in g:
            torch.testing.assert_close(g[k], w[k], rtol=1e-5, atol=1e-6)


def test_shapes_count_the_cross_attention_mlp_and_heads():
    from portbench import roofline
    real = harness.load_json(os.path.join(tiny.PB, "configs",
                                          "musicgen-large.json"))
    s = _reference().shapes(real)
    assert s["vocab"] == 4 * 2048 and len(s["layers"]) == 48
    layer = s["layers"][0]
    D, T = 2048, 64
    flops, _ = roofline.prefill(s, 8, 2048)
    # weights a position: 4·D² self, 2·D² cross (q, o), 2·D·8192 MLP
    per_pos = 2 * (4 * D * D + 2 * D * D + 2 * D * 8192)
    assert layer["xattn"]["token_flops"] == 4 * 64 * 32 * T
    assert flops > 48 * 8 * 2048 * per_pos
    assert 90e12 < flops < 120e12       # about 100 TFLOP a call
    _, nbytes = roofline.decode(s, 64, 251)
    # weights 2 bytes each, the self cache to position 251, the cross
    # cache read once: about 14 GB a step
    assert 12e9 < nbytes < 16e9


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_each_driver_runs_a_window_through_the_card_path(tmp_path, cell,
                                                          trace):
    r = root(tmp_path)
    res = harness.run_cell(r, cell, 2 ** 31 + 11, 1.0, bool(trace), "cpu",
                           time.perf_counter(), log=lambda *a: None)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    with open(os.path.join(r, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if trace:
        want = {m["name"] for m in bench["per_layer"]
                if cell in m["workloads"] and "mfu" in m["name"]}
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
    assert want and want <= set(res["metrics"])


def test_the_decode_window_refills_and_serves_the_delay(tmp_path):
    r = root(tmp_path)
    cell, drv = harness.build(r, "tiny.musicgen.decode", 5, "cpu")
    drv.window(0.0)
    # a batch serves N = 6 + 3 positions, then refills
    assert sum(drv._advance() is None for _ in range(2 * drv.N)) >= 1
    drv.release()
    served = drv.kept["served"]                 # [2, K, 6 + 3]
    assert served.shape == (2, 4, 9)
    pad = served == 32
    for k in range(4):
        # codebook k pads its first k served positions and its last 3 - k
        assert pad[:, k, :k].all() and not pad[:, k, k:k + 6].any()
        assert pad[:, k, k + 6:].all()
    assert all(v.shape[0] == 2 for layer in drv.kept["caches"]
               for v in layer.values())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_where_the_program_passes(tmp_path, cell):
    """As `test_portbench_control`: a limit between the program's largest
    and the fp8 control's smallest reading over three seeds passes the
    program and fails the control, the control reading at least three
    times the program."""
    r = root(tmp_path, "bfloat16")
    runs = [control.readings(r, cell, seed, 0.2, "cpu")
            for seed in (2 ** 31 + 3, 7, 123456789)]
    separated = 0
    for key in runs[0]["program"]:
        lower = max(o["program"][key] for o in runs)
        upper = min(o["control"][key] for o in runs)
        if lower == 0.0:
            continue
        assert upper >= 3 * lower, (key, runs)
        limit = {key: (lower * upper) ** 0.5}
        for o in runs:
            assert verdict({key: o["program"][key]}, limit)
            assert not verdict({key: o["control"][key]}, limit)
        separated += 1
    assert separated, runs


def _alter(logits):
    """Every row's least likely code made its top one."""
    out = logits.clone()
    low = out.argmin(-1, keepdim=True)
    return out.scatter(-1, low, float(out.max()) + 1.0)


def _faulty(lm, fault):
    prefill, decode = lm.prefill_step_fn, lm.decode_step_fn

    def make_prefill(cfg, capacity):
        fn = prefill(cfg, capacity)

        def run(params, batch):
            if fault == "half_batch":
                h = batch["codes"].shape[0] // 2
                logits, caches = fn(params, {k: v[:h]
                                             for k, v in batch.items()})
                return torch.cat([logits, logits]), [
                    tuple({k: torch.cat([v, v], dim=1) for k, v in e.items()}
                          for e in stack) for stack in caches]
            logits, caches = fn(params, batch)
            if fault == "state_unchanged":
                caches = [tuple({k: torch.zeros_like(v) for k, v in e.items()}
                                for e in stack) for stack in caches]
            elif fault == "code_altered":
                logits = _alter(logits)
            return logits, caches

        return run

    def make_decode(cfg):
        fn = decode(cfg)

        def run(params, caches, tokens, pos):
            if fault == "state_unchanged":
                saved = [[{k: v.clone() for k, v in e.items()} for e in s]
                         for s in caches]
                logits, _ = fn(params, caches, tokens, pos)
                for s, c in zip(saved, caches):
                    for se, ce in zip(s, c):
                        for k in ce:
                            ce[k].copy_(se[k])
                return logits, caches
            logits, caches = fn(params, caches, tokens, pos)
            if fault == "code_altered" and pos % 3 == 2:
                logits = _alter(logits)
            return logits, caches

        return run

    return make_prefill, make_decode


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "code_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            fault):
    from repro_torch.models import lm

    r = root(tmp_path)
    make_prefill, make_decode = _faulty(lm, fault)
    monkeypatch.setattr(lm, "prefill_step_fn", make_prefill)
    monkeypatch.setattr(lm, "decode_step_fn", make_decode)
    res = harness.run_cell(r, cell, 2 ** 31 + 5, 0.3, False, "cpu",
                           time.perf_counter(), log=lambda *a: None)
    assert not res["correct"], res["checks"]


def _digests(top: str) -> dict:
    out = {}
    for d, _, files in os.walk(top):
        if "__pycache__" in d:
            continue
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), top)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def test_the_new_files_are_found_by_name_with_no_file_edited(tmp_path):
    """A benchmark without the two cells' files, then those files added
    as they are in the repository: both cells run through the harness,
    and every file that was there before is byte for byte the same."""
    r = root(tmp_path)
    pb = os.path.join(r, "portbench")
    saved = {}
    for rel in NEW:
        with open(os.path.join(pb, rel), "rb") as f:
            saved[rel] = f.read()
        os.remove(os.path.join(pb, rel))
    before = _digests(pb)
    for rel, data in saved.items():
        with open(os.path.join(pb, rel), "wb") as f:
            f.write(data)
    for cell in CELLS:
        res = harness.run_cell(r, cell, 17, 0.2, True, "cpu",
                               time.perf_counter(), log=lambda *a: None)
        assert res["correct"], res["checks"]
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) >= set(NEW)
