"""The port's example twins (`repro_torch.examples`) against the reference
scripts in examples/, on the CPU.

fusion_search and autotune_tilesize's Part A print what the reference
scripts print, line for line (the scripts run in a subprocess). Part B,
given the reference's graph label and its Pallas candidates, picks the
reference's tile. quickstart, train_cost_model (dense and sparse) and
autotune_zoo run the reference scripts themselves, cut to a few steps
by patching their trainer config, beside the twins: the JAX trainer's
initial parameters cross with `core.params.from_jax_params`, dropout is
0 (jax.random and torch draw different masks), and both sides import
the architectures with the reference's importer (the port's importer
breaks some ops down otherwise, by design: tests/test_torch_hlo_import.py
lists every difference), so that both see the same programs. Counts
must be equal, losses, scores and metrics within 1e-4 relative, picks
equal (near-ties counted). serve_lm: the same tokens and logits within
1e-5 from the reference's params. The store, resume and
`_rebuild_program` of train_cost_model run on the port alone.
"""
import functools
import importlib
import importlib.util
import json
import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.autotuner as jautotuner
import repro.core.hlo_import as jhlo
import repro.core.model as jmodel
import repro.serving as jserving
import repro.training.trainer as jtrainer
from repro.kernels.flash_attention.ops import block_candidates as \
    jblock_candidates
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro_torch.core.analytical import AnalyticalModel
from repro_torch.core.evaluate import analytical_tile_scorer
from repro_torch.core.graph import KernelGraph
from repro_torch.core.params import from_jax_params
from repro_torch.core.simulator import TPUSimulator
from repro_torch.examples import autotune_tilesize, autotune_zoo, \
    fusion_search, quickstart, serve_lm, train_cost_model
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.params import lm_from_jax_params
from repro_torch.training.optim import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
RTOL = 1e-4
STEPS = 4
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _ref_env():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    return env


@functools.lru_cache(maxsize=None)
def _reference_stdout(script: str) -> list:
    res = subprocess.run([sys.executable, os.path.join(EXAMPLES, script)],
                         env=_ref_env(), capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    return res.stdout.splitlines()


def _lines_agree(got: list, want: list, *, skip=()) -> None:
    """Line for line the same text, each number within RTOL of the
    reference's (or within the last printed digit); lines that contain
    one of `skip` (host times) are held only in their text."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert NUM.sub("#", g) == NUM.sub("#", w), (g, w)
        if any(s in w for s in skip):
            continue
        for a, b in zip(NUM.findall(g), NUM.findall(w)):
            if "." not in b and "e" not in b:        # counts: exact
                assert a == b, (g, w)
                continue
            frac = b.split("e")[0].partition(".")[2]
            ulp = 10.0 ** -len(frac) * (10.0 ** int(b.split("e")[1])
                                        if "e" in b else 1.0)
            assert abs(float(a) - float(b)) <= RTOL * abs(float(b)) + ulp, \
                (g, w)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _port_graph(jgraph) -> KernelGraph:
    return KernelGraph.from_dict(jgraph.to_dict())


@functools.lru_cache(maxsize=None)
def _jax_arch(arch: str):
    """The reference importer's program of `arch` (traced once)."""
    return _REAL_JIMPORT(arch)


_REAL_JIMPORT = jhlo.import_arch_program


def _cached_jimport(arch, *a, **k):
    assert not a and not k
    return _jax_arch(arch)


def _port_arch(arch, device="cpu"):
    return _port_graph(_jax_arch(arch))


@functools.lru_cache(maxsize=None)
def _port_import_once(arch, device="cpu"):
    """The port importer's program of `arch` (traced once)."""
    from repro_torch.core.hlo_import import import_arch_program
    return import_arch_program(arch, device=device)


class _Rec:
    """What the patched reference recorded: its trainers' initial
    parameters and run results, its services, its results by name."""

    def __init__(self):
        self.init, self.runs, self.services, self.out = [], [], [], {}


def _patch_reference(monkeypatch, rec: _Rec, steps=None):
    """Reference classes that record into `rec`; `steps` overrides every
    TrainerConfig's step count; every CostModelConfig gets dropout 0."""
    real_trainer = jtrainer.CostModelTrainer
    real_service = jserving.CostModelService

    class Trainer(real_trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            rec.init.append(_np_tree(self.params))

        def run(self, *a, **k):
            out = super().run(*a, **k)
            rec.runs.append(out)
            return out

    class Service(real_service):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            rec.services.append(self)

    real_tc = jtrainer.TrainerConfig

    def trainer_config(**kw):
        return real_tc(**dict(kw, steps=steps or kw.get("steps", 2000)))
    monkeypatch.setattr(jtrainer, "CostModelTrainer", Trainer)
    monkeypatch.setattr(jtrainer, "TrainerConfig", trainer_config)
    monkeypatch.setattr(jserving, "CostModelService", Service)
    monkeypatch.setattr(jmodel, "CostModelConfig", functools.partial(
        jmodel.CostModelConfig, dropout=0.0))
    monkeypatch.setattr(jhlo, "import_arch_program", _cached_jimport)
    return Trainer, trainer_config


def _loading(make_trainer, rec: _Rec):
    """`make_trainer` whose trainer starts from the reference trainer's
    initial parameters."""
    def make(*a, **k):
        tr = make_trainer(*a, **k)
        tr._load_params(from_jax_params(rec.init[-1], tr.model_cfg,
                                        device="cpu").tree())
        return tr
    return make


def _near_ties(scores) -> int:
    s = np.sort(np.asarray(scores, np.float64))
    tol = 1e-5 * float(np.max(np.abs(s)))
    return int(sum(np.sum(s[i + 1:] - s[i] <= tol) for i in range(len(s))))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


# --------------------------------------------------------- host-only ones
def test_fusion_search_prints_the_reference_lines(capsys):
    fusion_search.main([])
    assert capsys.readouterr().out.splitlines() == \
        _reference_stdout("fusion_search.py")


def test_autotune_tilesize_part_a_prints_the_reference_lines(capsys):
    sim = TPUSimulator()
    autotune_tilesize.report_a(autotune_tilesize.part_a(
        sim, analytical_tile_scorer(AnalyticalModel())))
    assert capsys.readouterr().out.splitlines() == \
        _reference_stdout("autotune_tilesize.py")[:4]


def test_autotune_tilesize_part_b_reference_pick(capsys):
    """With the reference's label and Pallas candidates, Part B picks the
    reference's (512, 512) at its runtime and regret; with the port's
    candidates, one of them."""
    sim = TPUSimulator()
    scorer = analytical_tile_scorer(AnalyticalModel())
    res, tiles, _ = autotune_tilesize.part_b(
        sim, scorer, tiles=jblock_candidates(4096, 4096),
        program="repro.kernels.flash_attention")
    want = _reference_stdout("autotune_tilesize.py")[6:]
    assert len(tiles) == 16 and res.chosen_tile == (512, 512)
    assert want[0] == (f"  candidates: {len(tiles)}; chosen (block_q, "
                       f"block_k) = {res.chosen_tile}")
    assert want[1] == (f"  chosen runtime {res.chosen_runtime:.3e}s, "
                       f"exhaustive best {res.best_runtime:.3e}s, regret "
                       f"{100 * res.regret:.2f}%")
    res, tiles, scores = autotune_tilesize.part_b(sim, scorer)
    assert tiles == fa.block_candidates(4096, 4096)
    assert res.chosen_tile in tiles and len(scores) == len(tiles)
    autotune_tilesize.report_b(res, tiles, scores, None)
    out = capsys.readouterr().out.splitlines()
    assert out[2].startswith("  candidates: 4; chosen")
    assert [ln.split(":")[0] for ln in out[4:]] == [
        f"  rank {i}" for i in range(1, 5)]


# ------------------------------------------------------------- quickstart
def test_quickstart_matches_reference(monkeypatch, capsys):
    rec = _Rec()
    _patch_reference(monkeypatch, rec, steps=STEPS)
    monkeypatch.setattr(sys, "argv", ["quickstart.py"])
    real_eval = importlib.import_module("repro.core.evaluate").eval_tile_task

    def eval_tile_task(*a, **k):
        rec.out["metrics"] = real_eval(*a, **k)
        return rec.out["metrics"]
    monkeypatch.setattr("repro.core.evaluate.eval_tile_task", eval_tile_task)
    runpy.run_path(os.path.join(EXAMPLES, "quickstart.py"))
    want = capsys.readouterr().out.splitlines()

    sim = TPUSimulator()
    programs, dataset, norm = quickstart.build_data(sim)
    quickstart.report_data(programs, dataset)
    mc = quickstart.model_config(dropout=0.0)
    tr = _loading(quickstart.make_trainer, rec)(dataset, norm, mc, "cpu",
                                               STEPS)
    res = tr.run(resume=False)
    print(f"trained {quickstart.STEPS} steps, final rank loss "
          f"{res['loss']:.4f}")
    served = quickstart.serve(tr.model, mc, norm, dataset, sim)
    quickstart.report_serving(served)
    got = capsys.readouterr().out.splitlines()

    _lines_agree(got, want, skip=("p50",))
    st, jst = served["stats"], rec.services[0].stats()
    assert (st.graphs, st.flushes, st.hit_rate) == (jst.graphs, jst.flushes,
                                                     jst.hit_rate)
    _close(res["loss"], rec.runs[0]["loss"])
    jscores = rec.services[0].tile_scorer()(served["rec"].kernel,
                                            served["rec"].tiles)
    _close(served["scores"], jscores)
    assert np.argmin(served["scores"]) == np.argmin(jscores), \
        _near_ties(jscores)
    for key in ("mean_ape", "mean_kendall", "median_ape"):
        _close(served["metrics"][key], rec.out["metrics"][key])


# ------------------------------------------------------- train_cost_model
@pytest.fixture(scope="module")
def reference_driver():
    spec = importlib.util.spec_from_file_location(
        "reference_train_cost_model",
        os.path.join(EXAMPLES, "train_cost_model.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("adjacency", ["dense", "sparse"])
def test_train_cost_model_matches_reference(adjacency, reference_driver,
                                            monkeypatch, capsys, tmp_path):
    ref = reference_driver
    rec = _Rec()
    Trainer, _ = _patch_reference(monkeypatch, rec)
    monkeypatch.setattr(ref, "CostModelTrainer", Trainer)
    monkeypatch.setattr(ref, "CostModelConfig", jmodel.CostModelConfig)
    monkeypatch.setattr(ref, "import_arch_program", _cached_jimport)
    argv = ["--steps", "3", "--adjacency", adjacency]
    monkeypatch.setattr(sys, "argv", ["train_cost_model.py", *argv,
                                      "--ckpt-dir", str(tmp_path / "ref")])
    ref.main()
    want = capsys.readouterr().out.splitlines()

    twin = train_cost_model
    monkeypatch.setattr(twin, "import_arch_program", _port_arch)
    real_cfg = twin.model_config
    monkeypatch.setattr(twin, "model_config",
                        lambda adj, **kw: real_cfg(adj, dropout=0.0, **kw))
    monkeypatch.setattr(twin, "make_trainer", _loading(twin.make_trainer,
                                                       rec))
    out = twin.main([*argv, "--ckpt-dir", str(tmp_path / "port"),
                     "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()

    _lines_agree(got, want)
    assert rec.runs[0]["step"] == out["result"]["step"] == 3
    _close(out["result"]["loss"], rec.runs[0]["loss"])
    for g, w in zip(_metrics(tmp_path / "port" / "metrics.jsonl"),
                    _metrics(tmp_path / "ref" / "metrics.jsonl")):
        assert g["step"] == w["step"]
        for key in ("loss", "grad_norm", "lr"):
            _close(g[key], w[key])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref"))


def test_train_cost_model_store_builds_then_streams(monkeypatch, capsys,
                                                    tmp_path):
    """--store: the first run builds the store (the port's importer, in
    this process), the second streams it (the build is a manifest
    no-op); both print the same lines, over the in-memory run's
    programs."""
    twin = train_cost_model
    monkeypatch.setattr(twin, "STORE_WORKERS", 1)
    monkeypatch.setattr(twin, "import_arch_program", _port_import_once)
    base = ["--steps", "1", "--prefetch", "0", "--device", "cpu"]
    twin.main([*base, "--ckpt-dir", str(tmp_path / "mem")])
    mem = capsys.readouterr().out.splitlines()
    store = str(tmp_path / "store")
    outs = []
    for run in ("built", "streamed"):
        twin.main([*base, "--store", store, "--ckpt-dir",
                   str(tmp_path / run)])
        cap = capsys.readouterr()
        outs.append(cap.out.splitlines())
        assert ("no-op" in cap.err) == (run == "streamed"), cap.err
    assert outs[0] == outs[1]
    # the same programs; the store drops duplicate kernels as it writes
    assert outs[0][0].split(" -> ")[0] == mem[0].split(" -> ")[0]
    assert len(outs[0]) == len(mem) == 4


def test_train_cost_model_resumes(monkeypatch, capsys, tmp_path):
    """A run of 2 steps rerun to 4 in the same --ckpt-dir resumes from
    its checkpoint and ends where an uninterrupted 4-step run ends."""
    twin = train_cost_model
    monkeypatch.setattr(twin, "import_arch_program", _port_import_once)
    base = ["--prefetch", "0", "--device", "cpu"]
    one = twin.main(["--steps", "4", *base, "--ckpt-dir",
                     str(tmp_path / "one")])
    twin.main(["--steps", "2", *base, "--ckpt-dir", str(tmp_path / "two")])
    two = twin.main(["--steps", "4", *base, "--ckpt-dir",
                     str(tmp_path / "two")])
    capsys.readouterr()
    assert two["result"]["step"] == 4
    steps = [m["step"] for m in _metrics(tmp_path / "two" / "metrics.jsonl")
             if "loss" in m]
    assert steps == [2, 4]           # log_every 100: each run's last step
    for a, b in zip(tree_leaves(one["trainer"].model.tree()),
                    tree_leaves(two["trainer"].model.tree())):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    _close(two["eval"]["test_mape"], one["eval"]["test_mape"], 1e-6)


@pytest.mark.parametrize("name", ["attention_11", "mlp_0", "norm_3",
                                  "arch_yi-9b"])
def test_rebuild_program_matches_reference(name, reference_driver):
    """Synthetic names regenerate the reference's graph exactly; an arch
    name imports that arch with the port's importer."""
    got = train_cost_model._rebuild_program(name, device="cpu")
    if name.startswith("arch_"):
        from repro_torch.core.hlo_import import import_arch_program
        want = import_arch_program(name[5:], device="cpu")
        assert got.program == _jax_arch(name[5:]).program == name
        assert got.to_dict() == want.to_dict()
    else:
        assert got.to_dict() == reference_driver._rebuild_program(
            name).to_dict()


# ----------------------------------------------------------- autotune_zoo
def test_autotune_zoo_matches_reference(monkeypatch, capsys):
    """One arch (yi-9b), 3 training steps: the fusion decision, tile
    picks, query counts, budget and runtimes of the reference's script."""
    rec = _Rec()
    _patch_reference(monkeypatch, rec)
    for name in ("simulated_annealing_fusion", "autotune_program_tiles"):
        real = getattr(jautotuner, name)

        def wrapped(*a, _real=real, _name=name, **k):
            rec.out[_name] = _real(*a, **k)
            return rec.out[_name]
        monkeypatch.setattr(jautotuner, name, wrapped)
    argv = ["--train-steps", "3", "--archs", "yi-9b"]
    monkeypatch.setattr(sys, "argv", ["autotune_zoo.py", *argv])
    runpy.run_path(os.path.join(EXAMPLES, "autotune_zoo.py"))
    want = capsys.readouterr().out.splitlines()

    twin = autotune_zoo
    args = twin.parse_args([*argv, "--device", "cpu"])
    sim = TPUSimulator()
    print(f"training cost model ({args.train_steps} steps on synthetic "
          f"corpus)")
    tds, norm = twin.build_data(sim)
    cfg = twin.model_config()
    tr = _loading(twin.make_trainer, rec)(tds, norm, cfg, args)
    tr.run(args.train_steps, resume=False)
    t = twin.tune_arch(_port_arch("yi-9b"), tr.model, cfg, norm, args, sim)
    twin.report_arch(t, args)
    got = capsys.readouterr().out.splitlines()

    _lines_agree(got, want)
    jf, jt = rec.out["simulated_annealing_fusion"], \
        rec.out["autotune_program_tiles"]
    assert t["fusion"].best_decision.fuse == tuple(jf.best_decision.fuse)
    assert (t["fusion"].model_evals, t["fusion"].hardware_evals) == (
        jf.model_evals, jf.hardware_evals)
    assert [r.chosen_tile for r in t["tiles"].results] == [
        r.chosen_tile for r in jt.results]
    _close(t["fusion"].best_runtime, jf.best_runtime)


# ---------------------------------------------------------------- serve_lm
def test_serve_lm_matches_reference():
    """h2o-danube-3-4b's smoke config (f32), the reference's seed-0 params
    carried across: the greedy tokens equal, the prefill's and every
    step's last logits within 1e-5."""
    batch, prompt_len, steps = 8, 48, 8
    jcfg = jreg.get_smoke_config("h2o-danube-3-4b")
    cfg = serve_lm.setup("h2o-danube-3-4b")
    assert cfg.dtype == jcfg.dtype == "float32"
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    capacity = prompt_len + steps
    prefill = jax.jit(jlm.prefill_step_fn(jcfg, capacity=capacity))
    decode = jax.jit(jlm.decode_step_fn(jcfg))
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                                (batch, prompt_len))
    logits, cache = prefill(jparams, {"tokens": jnp.asarray(prompts,
                                                           jnp.int32)})
    want_logits, want_tokens = [np.asarray(logits[:, -1])], []
    for t in range(prompt_len, capacity):
        nxt = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(
            jnp.int32)
        want_tokens.append(np.asarray(nxt)[:, 0])
        logits, cache = decode(jparams, cache, nxt,
                               jnp.asarray(t, jnp.int32))
        want_logits.append(np.asarray(logits[:, -1]))

    params = lm_from_jax_params(_np_tree(jparams), cfg, device="cpu")
    got = serve_lm.generate(params, cfg,
                            serve_lm.make_prompts(cfg, batch, prompt_len,
                                                  "cpu"),
                            steps, keep_logits=True)
    np.testing.assert_array_equal(got["tokens"], np.stack(want_tokens, 1))
    assert len(got["logits"]) == len(want_logits) == steps + 1
    for g, w in zip(got["logits"], want_logits):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-34b"])
def test_serve_lm_refuses_archs_without_token_prompts(arch, capsys):
    with pytest.raises(ValueError, match="prefill needs"):
        serve_lm.main(["--arch", arch, "--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_serve_lm_main_prints_the_reference_lines(capsys):
    serve_lm.main(["--decode-steps", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("h2o-danube-3-4b-smoke: prefill 8x48 in ")
    assert re.fullmatch(r"decoded 32 tokens in \S+s -> \S+ tok/s \(CPU\)",
                        out[1]), out[1]
    assert re.fullmatch(r"first request's continuation: \[(\d+, ){3}\d+\]",
                        out[2]), out[2]


# ---------------------------------------------------------- entry points
TWINS = ("fusion_search", "autotune_tilesize", "quickstart", "serve_lm",
         "train_cost_model", "autotune_zoo")


def test_twins_import_without_running_and_without_jax():
    code = f"""
import importlib, json, sys
for n in {TWINS!r}:
    importlib.import_module("repro_torch.examples." + n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps(bad))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == ["[]"]     # nothing else printed


@pytest.mark.parametrize("name,argv", [
    ("autotune_tilesize", []), ("quickstart", []), ("serve_lm", []),
    ("train_cost_model", []), ("train_cost_model", ["--dp", "2"]),
    ("autotune_zoo", [])])
def test_twins_refuse_to_run_without_a_card(name, argv, monkeypatch):
    """Their default device is the card: without one they raise before
    any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
