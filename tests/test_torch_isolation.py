"""The port stands alone: no jax, nothing of `repro`, no silent CPU.

Every `repro_torch` module and `chip_smoke.py` import in a fresh process
without pulling `jax` or any `repro` module into `sys.modules`, and no
source file of theirs imports either. Entry points asked for the card
(their default) on a machine without CUDA raise instead of running on
the CPU.
"""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card, whatever the host
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run(code: str, **kw) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT, **kw)


def _sources():
    out = [SMOKE]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_everything_loads_no_jax_and_no_repro():
    code = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {ROOT!r})
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({{"mods": mods, "bad": bad}}))
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.model" in out["mods"]
    assert "repro_torch.kernels.segment_aggregate" in out["mods"]
    assert {"repro_torch.quant.scale", "repro_torch.quant.quantize",
            "repro_torch.data.segmentation"} <= set(out["mods"])
    assert {"repro_torch.models.config", "repro_torch.models.registry",
            "repro_torch.models.inputs", "repro_torch.models.layers",
            "repro_torch.models.lm", "repro_torch.models.params",
            "repro_torch.configs.h2o_danube3_4b",
            "repro_torch.configs.qwen3_14b",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.ssd_scan",
            "repro_torch.launch.serve"} <= set(out["mods"])
    assert sum(m.startswith("repro_torch.configs.")
               for m in out["mods"]) == 10
    assert out["bad"] == []


def test_training_modules_load_no_jax_and_no_repro():
    """The data-parallel and LM-training modules, on their own."""
    mods = ["repro_torch.sharding", "repro_torch.sharding.mesh",
            "repro_torch.training.compression",
            "repro_torch.training.adafactor",
            "repro_torch.training.pipeline",
            "repro_torch.training.trainer", "repro_torch.models.lm",
            "repro_torch.launch.train"]
    code = f"""
import importlib, json, sys
for m in {mods!r}:
    importlib.import_module(m)
from repro_torch.models.lm import make_optimizer, train_step_fn
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps(bad))
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_training_entry_points_refuse_to_run_without_a_card():
    code = """
import torch
from repro_torch.launch.train import main
from repro_torch.sharding import init_distributed, make_train_mesh, \
    spawn_ranks
assert not torch.cuda.is_available()
for call in (lambda: main(["lm", "--arch", "yi-9b", "--smoke"]),
             lambda: main(["cost-model", "--dp", "2"]),
             lambda: init_distributed(rank=0, world_size=1,
                                      init_method="file:///nonexistent"),
             lambda: spawn_ranks(print, (), 2)):
    try:
        call()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise SystemExit("ran without a card")
print("refused")
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "refused"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_neither_jax_nor_repro(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {n}"


def test_entry_points_refuse_to_run_without_a_card():
    code = """
import torch
from repro_torch.core.model import CostModelConfig, cost_model_init
from repro_torch.core.params import from_jax_params
assert not torch.cuda.is_available()
cfg = CostModelConfig(hidden_dim=16, opcode_embed_dim=8)
for call in (lambda: cost_model_init(torch.Generator(), cfg),
             lambda: from_jax_params({}, cfg)):
    try:
        call()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise SystemExit("ran without a card")
print("refused")
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "refused"


def test_lm_entry_points_refuse_to_run_without_a_card():
    code = """
import torch
from repro_torch.models import inputs, lm, registry
from repro_torch.models.config import SMOKE_SHAPE
from repro_torch.models.params import lm_from_jax_params
assert not torch.cuda.is_available()
cfg = registry.get_smoke_config("h2o-danube-3-4b")
for call in (lambda: lm.init_params(torch.Generator(), cfg),
             lambda: lm_from_jax_params({}, cfg),
             lambda: lm.init_cache(cfg, 1, 8),
             lambda: inputs.make_batch(cfg, SMOKE_SHAPE)):
    try:
        call()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise SystemExit("ran without a card")
print("refused")
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "refused"


def test_lm_serve_cli_refuses_without_a_card():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "h2o-danube-3-4b", "--smoke"], env=_env(), capture_output=True,
        text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "tok/s" not in res.stdout


def test_serve_cli_refuses_without_a_card():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_costmodel",
         "--programs", "1", "--rounds", "1"], env=_env(),
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "queries/s" not in res.stdout


def test_chip_smoke_fails_without_a_card():
    res = subprocess.run([sys.executable, SMOKE], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    res = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
