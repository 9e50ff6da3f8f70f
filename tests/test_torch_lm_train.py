"""The port's LM train step (repro_torch.models.lm.train_step_fn, with
AdamW or Adafactor, in place) against the JAX reference, on the CPU at
smoke size.

The reference's params cross with `lm_from_jax_params`; the batch is the
reference's `make_batch` (numpy-drawn: tokens; musicgen's frame
embeddings and labels; llava's tokens after a patch prefix). One step
from the same params on the same global batch (4 sequences of 32
positions, microbatches of 2), for every arch the port runs (the MoE
ffn and the SSD mixer included): the loss within 1e-5
relative; the params after the step within f32 rounding wherever the
reference's gradient is above 1e-3 of its largest, and within the
step's bound 2·lr elsewhere (Adam's first step moves an entry by ±lr
for a gradient of rounding size, in either package's sign: the guard of
tests/test_torch_training.py). Also: the in-place updates against the
pure ones, bit for bit; microbatch invariance; remat and the scan
switches change no number; the flash and ssd kernels refuse to be
differentiated; the `train lm` CLI.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.models.config import ShapeSpec
from repro.models.inputs import make_batch as jmake_batch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import lm
from repro_torch.models import registry
from repro_torch.models.params import lm_from_jax_params
from repro_torch.training import adafactor as PA
from repro_torch.training import optim as PO

ARCHS = ["h2o-danube-3-4b", "yi-9b", "yi-34b", "qwen3-14b",
         "granite-moe-3b-a800m", "musicgen-large", "llava-next-34b",
         "mamba2-2.7b", "recurrentgemma-9b"]
B, S = 4, 32
LOSS_RTOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(cfg, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _batch(cfg, seed=1):
    """The reference's `make_batch` of B x S positions as numpy arrays
    (for tokens alone: `_tokens(cfg, seed)`'s)."""
    return {k: np.array(v) for k, v in jmake_batch(
        cfg, ShapeSpec("train", S, B, "train"), seed=seed).items()}


def _jax_step(cfg, jparams, batch):
    """The reference's step: (loss, params after, the full batch's grads,
    lr)."""
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    opt_init, _ = jlm.make_optimizer(cfg)
    new, _, stats = jax.jit(jlm.train_step_fn(cfg))(
        jparams, opt_init(jparams), batch)
    grads = jax.jit(jax.grad(lambda p: jlm.loss_fn(p, cfg, batch)))(jparams)
    return (float(stats["loss"]), [np.asarray(x) for x in
                                   jax.tree_util.tree_leaves(new)],
            [np.asarray(x) for x in jax.tree_util.tree_leaves(grads)],
            float(stats["lr"]))


def _port_step(cfg, jparams, batch):
    params = lm_from_jax_params(_np(jparams), cfg, device="cpu")
    opt_init, _ = lm.make_optimizer(cfg)
    new, _, stats = lm.train_step_fn(cfg)(
        params, opt_init(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(stats["loss"]), [x.detach().numpy()
                                  for x in PO.tree_leaves(new)]


def _holds(port, ref, grads, lr):
    gmax = max(float(np.abs(g).max()) for g in grads)
    for p, j, g in zip(port, ref, grads):
        big = np.abs(g) > 1e-3 * gmax
        np.testing.assert_allclose(p[big], j[big], rtol=1e-6, atol=1e-7)
        assert np.all(np.abs(p - j) <= 2 * lr * (1 + 1e-6))


def _check_against_jax(cfg_j, cfg_p, seed=0):
    jparams = jlm.init_params(jax.random.key(seed), cfg_j)
    batch = _batch(cfg_j)
    jloss, jnew, jgrads, lr = _jax_step(cfg_j, jparams, batch)
    ploss, pnew = _port_step(cfg_p, jparams, batch)
    assert ploss == pytest.approx(jloss, rel=LOSS_RTOL)
    assert len(pnew) == len(jnew)
    _holds(pnew, jnew, jgrads, lr)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    cfg_j, cfg_p = jreg.get_smoke_config(arch), registry.get_smoke_config(arch)
    assert cfg_p.microbatch < B            # more than one microbatch
    _check_against_jax(cfg_j, cfg_p)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "qwen3-14b"])
@pytest.mark.parametrize("mode", ["scan_of_grads", "grad_of_scan"])
def test_grad_accum_modes_match_jax(arch, mode):
    kw = dict(grad_accum=mode)
    _check_against_jax(
        dataclasses.replace(jreg.get_smoke_config(arch), **kw),
        dataclasses.replace(registry.get_smoke_config(arch), **kw))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "yi-9b"])
def test_adafactor_step_matches_jax(arch):
    kw = dict(optimizer="adafactor")
    _check_against_jax(
        dataclasses.replace(jreg.get_smoke_config(arch), **kw),
        dataclasses.replace(registry.get_smoke_config(arch), **kw))


# ------------------------------------------------- in place vs pure
def _random_tree(rng, dtype):
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    return {"stacked": {"w": t(3, 5, 7), "b": t(3, 7)}, "embed": t(11, 5),
            "norm": [t(5)]}


def _bits(tree):
    return [x.float().numpy().tobytes() for x in PO.tree_leaves(tree)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip,wd", [(None, 0.0), (0.5, 0.1), (1e3, 0.1)])
def test_adamw_update_in_place_is_the_pure_update(dtype, clip, wd):
    rng = np.random.default_rng(0)
    cfg = PO.AdamWConfig(lr=3e-3, weight_decay=wd, grad_clip_norm=clip,
                         schedule="cosine", warmup_steps=2)
    pure = _random_tree(rng, dtype)
    inplace = PO.tree_map(lambda x: x.clone(), pure)
    s_pure, s_in = PO.adamw_init(pure), PO.adamw_init(inplace)
    with torch.no_grad():
        for _ in range(3):
            grads = _random_tree(rng, dtype)
            pure, s_pure, st_pure = PO.adamw_update(pure, grads, s_pure, cfg)
            out, s_in, st_in = PO.adamw_update_(inplace, grads, s_in, cfg)
            assert out is inplace
    assert _bits(pure) == _bits(inplace)
    assert _bits(s_pure["m"]) == _bits(s_in["m"])
    assert _bits(s_pure["v"]) == _bits(s_in["v"])
    assert int(s_in["step"]) == 3
    assert float(st_pure["grad_norm"]) == float(st_in["grad_norm"])
    assert float(st_pure["lr"]) == float(st_in["lr"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adafactor_update_in_place_is_the_pure_update(dtype):
    rng = np.random.default_rng(1)
    pure = _random_tree(rng, dtype)
    inplace = PO.tree_map(lambda x: x.clone(), pure)
    s_pure, s_in = PA.adafactor_init(pure), PA.adafactor_init(inplace)
    with torch.no_grad():
        for _ in range(3):
            grads = _random_tree(rng, dtype)
            pure, s_pure, st_pure = PA.adafactor_update(pure, grads, s_pure,
                                                        lr=1e-2)
            _, s_in, st_in = PA.adafactor_update_(inplace, grads, s_in,
                                                  lr=1e-2)
    assert _bits(pure) == _bits(inplace)
    assert _bits(s_pure["factored"]) == _bits(s_in["factored"])
    assert float(st_pure["grad_norm"]) == float(st_in["grad_norm"])


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros(3, 4, 5), "b": torch.zeros(5)}
    st = PA.adafactor_init(params)["factored"]
    assert st["w"]["v_row"].shape == (3, 4)
    assert st["w"]["v_col"].shape == (3, 5)
    assert st["b"]["v"].shape == (5,)


def test_adafactor_update_matches_jax():
    from repro.training import adafactor as JA
    rng = np.random.default_rng(2)
    p = {"w": rng.standard_normal((3, 4, 6)).astype(np.float32),
         "b": rng.standard_normal(6).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = JA.adafactor_init(jp), PA.adafactor_init(tp)
    with torch.no_grad():
        for _ in range(3):
            g = {"w": rng.standard_normal((3, 4, 6)).astype(np.float32),
                 "b": rng.standard_normal(6).astype(np.float32)}
            jp, js, _ = JA.adafactor_update(
                jp, {k: jnp.asarray(v) for k, v in g.items()}, js, lr=1e-2)
            tp, ts, _ = PA.adafactor_update_(
                tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
                lr=1e-2)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        for f in ts["factored"][k]:
            np.testing.assert_allclose(ts["factored"][k][f].numpy(),
                                       np.asarray(js["factored"][k][f]),
                                       rtol=1e-5)


# ---------------------------------------------- step invariances
def _port_loss_and_grads(cfg, params, tokens):
    leaves = [x.requires_grad_(True) for x in PO.tree_leaves(params)]
    loss = lm.loss_fn(params, cfg, {"tokens": tokens})
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _smoke(arch="yi-9b", seed=0):
    cfg = registry.get_smoke_config(arch)
    params = lm.init_params(torch.Generator().manual_seed(seed), cfg,
                            device="cpu")
    return cfg, params, torch.from_numpy(_tokens(cfg))


def test_microbatch_accumulation_invariance():
    """The same global batch in 1, 2 or 4 microbatches: the same loss and
    update (tests/test_models.py's check, on the port)."""
    cfg, params, tokens = _smoke()
    losses, updated = [], []
    for mb in (1, 2, 4):
        c = dataclasses.replace(cfg, microbatch=mb)
        p = PO.tree_map(lambda x: x.detach().clone(), params)
        opt_init, _ = lm.make_optimizer(c)
        new, _, stats = lm.train_step_fn(c)(p, opt_init(p),
                                            {"tokens": tokens})
        losses.append(float(stats["loss"]))
        updated.append([x.detach().numpy() for x in PO.tree_leaves(new)])
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    assert losses[0] == pytest.approx(losses[2], rel=1e-5)
    # one update of |lr| ~ 3e-4 an entry; rounding-size gradients may
    # take either sign, so hold the updates to the step's bound
    for a, b in zip(updated[0], updated[2]):
        assert np.all(np.abs(a - b) <= 2 * 3e-4 * (1 + 1e-6))


@pytest.mark.parametrize("kw", [dict(remat="none"), dict(remat="dots"),
                                dict(scan_layers=False),
                                dict(scan_microbatch=False)])
def test_remat_and_scan_switches_change_no_number(kw):
    cfg, params, tokens = _smoke("h2o-danube-3-4b")
    l0, g0 = _port_loss_and_grads(cfg, params, tokens)      # remat full
    l1, g1 = _port_loss_and_grads(dataclasses.replace(cfg, **kw), params,
                                  tokens)
    assert cfg.remat == "full"
    assert l0.numpy().tobytes() == l1.numpy().tobytes()
    for a, b in zip(g0, g1):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_grad_accum_modes_give_the_same_loss():
    cfg, params, tokens = _smoke("qwen3-14b")
    out = []
    for mode in ("scan_of_grads", "grad_of_scan"):
        c = dataclasses.replace(cfg, grad_accum=mode)
        p = PO.tree_map(lambda x: x.detach().clone(), params)
        _, _, stats = lm.train_step_fn(c)(p, lm.make_optimizer(c)[0](p),
                                          {"tokens": tokens})
        out.append(float(stats["loss"]))
    assert out[0] == pytest.approx(out[1], rel=1e-6)


def test_train_step_rejects_a_ragged_microbatch_split():
    cfg, params, tokens = _smoke()
    c = dataclasses.replace(cfg, microbatch=3)
    with pytest.raises(ValueError, match="microbatches of 3"):
        lm.train_step_fn(c)(params, lm.make_optimizer(c)[0](params),
                            {"tokens": tokens})


def test_losses_fall_on_a_repeated_batch():
    for opt in ("adamw", "adafactor"):
        cfg, params, tokens = _smoke("h2o-danube-3-4b")
        cfg = dataclasses.replace(cfg, optimizer=opt)
        step = lm.train_step_fn(cfg, PO.AdamWConfig(lr=1e-2,
                                                    schedule="constant"))
        state = lm.make_optimizer(cfg)[0](params)
        losses = []
        for _ in range(4):
            params, state, stats = step(params, state, {"tokens": tokens})
            losses.append(float(stats["loss"]))
        assert losses[-1] < losses[0], (opt, losses)


# ------------------------------------------- kernels refuse grads
def test_use_pallas_attn_refuses_a_differentiated_forward():
    cfg, params, tokens = _smoke("h2o-danube-3-4b")
    cfg = dataclasses.replace(cfg, use_pallas_attn=True)
    with pytest.raises(RuntimeError, match="use_pallas_attn=False"):
        lm.train_step_fn(cfg)(params, lm.make_optimizer(cfg)[0](params),
                              {"tokens": tokens})
    with pytest.raises(RuntimeError, match="flash_attention has no "
                                           "backward"):
        _port_loss_and_grads(cfg, params, tokens)
    with torch.no_grad():       # the forward alone still runs
        plain = lm.loss_fn(params, dataclasses.replace(
            cfg, use_pallas_attn=False), {"tokens": tokens})
        flash = lm.loss_fn(params, cfg, {"tokens": tokens})
    assert float(flash) == pytest.approx(float(plain), rel=1e-5)


def test_flash_and_ssd_wrappers_refuse_inputs_that_require_grad():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    kv = torch.randn(1, 8, 1, 16)
    with pytest.raises(RuntimeError, match="q require"):
        flash_attention(q, kv, kv)
    S = torch.randn(1, 2, 1, 3, 4)
    d = torch.rand(1, 2, 1, requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd_scan has no backward"):
        ssd_scan(S, d)
    with torch.no_grad():
        assert flash_attention(q, kv, kv).shape == q.shape
        assert ssd_scan(S, d)[1].shape == (1, 1, 3, 4)


# ---------------------------------------------------------------- CLI
def test_cli_trains_an_lm_on_the_cpu(capsys):
    from repro_torch.launch.train import main
    main(["lm", "--arch", "h2o-danube-3-4b", "--smoke", "--steps", "2",
          "--seq", "32", "--batch", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=h2o-danube-3-4b-smoke params=")
    assert [line.split(":")[0] for line in out[1:]] == ["step 0", "step 1"]
    assert all(np.isfinite(float(line.split("loss=")[1].split()[0]))
               for line in out[1:])


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "musicgen-large",
                                  "llava-next-34b", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
def test_cli_trains_the_zoo_archs_on_the_cpu(arch, capsys):
    """`train lm` on the MoE, front-end, SSD and RG-LRU archs: make_batch gives
    each its inputs (llava: --seq 32 counts its 16 patch positions)."""
    from repro_torch.launch.train import main
    main(["lm", "--arch", arch, "--smoke", "--steps", "2", "--seq", "32",
          "--batch", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch}-smoke params=")
    assert [line.split(":")[0] for line in out[1:]] == ["step 0", "step 1"]
    assert all(np.isfinite(float(line.split("loss=")[1].split()[0]))
               for line in out[1:])


def test_cli_lm_needs_the_card_by_default():
    from repro_torch.launch.train import main
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["lm", "--arch", "yi-9b", "--smoke"])
