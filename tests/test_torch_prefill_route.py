"""Prefill's attention route (`layers.attend`), on the CPU at smoke size.

With `use_pallas_attn` the `attn` and `swa` layers of `prefill_step_fn`
attend through the flash-attention kernel (here its plain version, the
same softmax), counted as `attn.kernel_calls`; without it through
`chunked_attention`, counted as `attn.chunked_calls`. The two routes
give the same logits within the dtype's rounding, and the same decode
caches: the first layer's bit for bit (its keys and values come before
any attention), the later layers' within the rounding that the earlier
layers' attention passes on. MLA prefills through `chunked_attention`
whatever the flag says. This file imports nothing of JAX.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import tracing
from repro_torch.models import lm
from repro_torch.models import registry

B, S = 2, 40            # S > the danube smoke window of 16: the window
#                         masks keys and the prefill ring buffer wraps
# (rtol, atol) of flag on against off, logits and caches
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (1.6e-2, 1e-5)}


@pytest.fixture(autouse=True)
def _closed():
    """No test leaves a recording open for the next."""
    yield
    if tracing._rec is not None:
        tracing.stop()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _prefill(arch, dtype, flag):
    """(logits, caches, counters) of one traced prefill of the smoke
    model in `dtype` with `use_pallas_attn=flag`, and the config."""
    cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype=dtype,
                              use_pallas_attn=flag)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    tracing.start()
    with torch.no_grad():
        logits, caches = lm.prefill_step_fn(cfg, capacity=S + 8)(
            params, {"tokens": tokens})
    _, counters = tracing.stop()
    return logits, caches, counters, cfg


def _attn_layers(cfg) -> int:
    return sum(t.split("+")[0] in ("attn", "swa")
               for t in cfg.layer_types())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "h2o-danube-3-4b"])
def test_prefill_with_the_flag_attends_through_the_kernel(arch, dtype):
    logits, caches, counters, cfg = _prefill(arch, dtype, True)
    want, want_caches, want_counters, _ = _prefill(arch, dtype, False)
    n = _attn_layers(cfg)
    assert n == cfg.num_layers > 1
    assert counters.get("attn.kernel_calls") == n
    assert "attn.chunked_calls" not in counters
    assert want_counters.get("attn.chunked_calls") == n
    assert "attn.kernel_calls" not in want_counters

    rtol, atol = TOL[dtype]
    assert logits.dtype == want.dtype
    torch.testing.assert_close(logits, want, rtol=rtol, atol=atol)
    # caches: [stack][element] dicts k, v, k_pos with a leading layer axis
    first = caches[0][0]
    for key in ("k", "v", "k_pos"):
        assert torch.equal(first[key][0], want_caches[0][0][key][0]), key
    got, ref = list(_leaves(caches)), list(_leaves(want_caches))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
        else:
            assert torch.equal(a, b)


def test_mla_prefill_keeps_chunked_attention_with_the_flag():
    arch = "deepseek-v3-671b"
    logits, caches, counters, cfg = _prefill(arch, "float32", True)
    want, want_caches, want_counters, _ = _prefill(arch, "float32", False)
    assert "attn.kernel_calls" not in counters
    assert counters["attn.chunked_calls"] == cfg.num_layers == 2
    assert counters == want_counters
    assert torch.equal(logits, want)
    for a, b in zip(_leaves(caches), _leaves(want_caches)):
        assert torch.equal(a, b)


def test_train_forward_counts_the_same_route():
    """The train forward (`forward_trunk`) takes the same route, under
    the same `attn.core` span, one span and one count a layer."""
    arch = "granite-moe-3b-a800m"
    for flag, name in ((True, "attn.kernel_calls"),
                       (False, "attn.chunked_calls")):
        cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                  use_pallas_attn=flag)
        params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (B, S),
                               generator=torch.Generator().manual_seed(1))
        tracing.start()
        with torch.no_grad():
            lm.forward_trunk(params, cfg,
                             lm._embed_inputs(params, cfg,
                                              {"tokens": tokens}))
        spans, counters = tracing.stop()
        assert counters[name] == cfg.num_layers
        assert sum(s["name"] == "attn.core" for s in spans) \
            == cfg.num_layers
