"""What the benchmark may import, how it finds its files, and that every
driver runs a short window through the functions a card run uses, on the
CPU at the tiny sizes. Nothing here needs a card.

    PYTHONPATH=src:. python -m pytest -q portbench/tests
"""
from __future__ import annotations

import ast
import copy
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import pytest

from portbench import harness
from portbench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the reference and the traffic code may not import the program either
PLAIN = ("reference", "traffic.py", "weights.py",
         os.path.join("tests", "mamba2_reference.py"))


def _modules():
    for d, _, files in os.walk(tiny.PB):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path: str) -> set[str]:
    """Top-level names of every module that `path` imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, tiny.PB))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = _imports(path) & FORBIDDEN
    assert not found, f"{path} imports {found}"
    rel = os.path.relpath(path, tiny.PB)
    if rel.startswith(PLAIN):
        assert "repro_torch" not in _imports(path), rel


def test_import_check_compares_whole_top_level_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.models\nfrom jax.numpy import ones\n"
                 "import reprox\n")
    assert _imports(str(p)) & FORBIDDEN == {"jax"}


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


def _one_layer_granite():
    conf = tiny.config("granite-moe-3b-a800m")
    conf["num_hidden_layers"] = 1
    conf["port"]["stacks"] = [[["attn+moe"], 1]]
    with open(os.path.join(tiny.PB, "reference",
                           "granite-moe-3b-a800m.py")) as f:
        return conf, f.read()


def _mamba2():
    with open(os.path.join(tiny.PB, "tests", "mamba2_reference.py")) as f:
        return copy.deepcopy(tiny.MAMBA2), f.read()


@pytest.mark.parametrize("new_config", [_one_layer_granite, _mamba2],
                         ids=["granite-one-layer", "mamba2-ssm"])
def test_new_config_cell_and_metric_are_found_by_name(tmp_path, new_config):
    """A configuration (one of a kind that no cell runs yet among them),
    traffic mix, cell and per-layer metric added as new files (and
    entries in BENCHMARK.json) run with no file edited."""
    r = tiny.root(tmp_path, "float32")
    pb = os.path.join(r, "portbench")
    before = _digests(pb)
    conf, ref = new_config()
    new = {
        "configs/new-config.json": conf,
        "traffic/tiny.prefill.b3.json": {"driver": "prefill", "batch": 3,
                                         "prompt_len": 16, "trace_calls": 1},
        "workloads/tiny.new.json": {"limits": {"logits_err": 1e-4,
                                               "cache_err": 1e-4}},
    }
    for rel, obj in new.items():
        with open(os.path.join(pb, rel), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(pb, "metrics", "calls_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx['window']['calls'])\n")
    # a new configuration brings its reference under its own name
    with open(os.path.join(pb, "reference", "new-config.py"), "w") as f:
        f.write(ref)
    bench_path = os.path.join(r, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "new-config", "source": "tiny", "reduced": [],
        "file": "portbench/configs/new-config.json", "why": "tiny"})
    bench["workloads"].append({"name": "tiny.new", "config": "new-config",
                               "traffic": "tiny.prefill.b3", "chips": 1,
                               "why": "tiny"})
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "serve path",
                               "moves": "prefill_tokens_per_s",
                               "workloads": ["tiny.new"]})
    bench["end_to_end"][0]["workloads"].append("tiny.new")
    bench["per_layer"][0]["workloads"].append("tiny.new")       # mfu.prefill
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    res = harness.run_cell(r, "tiny.new", 11, 0.2, True, "cpu",
                           time.perf_counter(), log=lambda *a: None)
    assert res["correct"], res["checks"]
    assert res["metrics"]["calls_seen"]["value"] >= 1
    assert res["metrics"]["mfu.prefill"]["value"] > 0
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("module", [
    "deepseek_v3_671b", "granite_moe_3b", "h2o_danube3_4b", "llava_next_34b",
    "mamba2_2p7b", "musicgen_large", "qwen3_14b", "recurrentgemma_9b",
    "yi_34b", "yi_9b"])
def test_every_nested_group_of_the_program_config_is_built(module):
    """`port_lm.model_config` gives back the program's own configs (moe,
    mla, ssm, rglru and the stacks) from their JSON form."""
    import importlib

    from repro_torch.models.config import ModelConfig

    from portbench import port_lm

    mod = importlib.import_module(f"repro_torch.configs.{module}")
    for cfg in (mod.config(), mod.smoke_config()):
        port = json.loads(json.dumps(dataclasses.asdict(cfg)))
        assert port_lm.model_config(port) == cfg
    with pytest.raises(KeyError):
        port_lm.from_dict(ModelConfig, {**port, "no_such_field": 1})


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_each_driver_runs_a_window_through_the_card_path(tmp_path, cell,
                                                          trace):
    r = tiny.root(tmp_path, "float32")
    res = harness.run_cell(r, cell, 2 ** 31 + 11, 1.0, bool(trace), "cpu",
                           time.perf_counter(), log=lambda *a: None)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
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


def _cli(cwd: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "granite-moe.prefill-4k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_cli_fails_without_a_card():
    out = _cli(tiny.REPO)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "{" not in out.stdout


def test_cli_fails_with_only_the_benchmark_files(tmp_path):
    import shutil
    shutil.copytree(tiny.PB, tmp_path / "portbench")
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    out = _cli(str(tmp_path))
    assert out.returncode != 0 and "{" not in out.stdout
