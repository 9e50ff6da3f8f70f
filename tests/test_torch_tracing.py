"""The port's in-program spans and counters (`repro_torch.tracing`): off by
default, nesting, the clock, the span tree and MoE counters of a tiny
MoE + MLA model (deepseek-v3-671b's smoke config: one dense and one MoE
layer) through prefill and three decode steps, and outputs bit-identical
with tracing on and off. One `cuda` test checks on the card that the
spans share the profiler's clock:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tracing.py

This file imports nothing of JAX.
"""
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import tracing
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import registry

ARCH = "deepseek-v3-671b"
B, S, STEPS = 2, 20, 3

MOE = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
       "moe.shared")


@pytest.fixture(autouse=True)
def _closed():
    """No test leaves a recording open for the next."""
    yield
    if tracing._rec is not None:
        tracing.stop()


def _tree(spans, index=None):
    """(name, children) of the spans under `index` (the roots for None)."""
    return [(s["name"], _tree(spans, i)) for i, s in enumerate(spans)
            if s["parent"] == index]


def test_off_by_default_span_is_one_shared_noop():
    assert tracing._rec is None
    a, b = tracing.span("a"), tracing.span("b")
    assert a is b is tracing.NOOP and not tracing.recording()
    with a as s:
        assert s is None
        tracing.count("c", 5)
        tracing.count("d", torch.ones(3))
    tracing.start()
    assert tracing.stop() == ([], {})


def test_nested_spans_parents_steps_and_self_times():
    tracing.start()
    for _ in range(2):
        with tracing.span("root") as s:
            s.attrs["batch"] = 4
            with tracing.span("a"):
                time.sleep(0.002)
                with tracing.span("a.inner"):
                    time.sleep(0.002)
            with tracing.span("b"):
                time.sleep(0.001)
    tracing.count("n", 2)
    tracing.count("n", torch.tensor([0, 3, 0, 1]))
    spans, counters = tracing.stop()
    assert [s["name"] for s in spans] == ["root", "a", "a.inner", "b"] * 2
    assert [s["parent"] for s in spans] == [None, 0, 1, 0, None, 4, 5, 4]
    assert [s["step"] for s in spans] == [0] * 4 + [1] * 4
    assert spans[0]["attrs"] == {"batch": 4} and spans[1]["attrs"] == {}
    assert counters == {"n": 4}

    def dur(s):
        return s["end_ns"] - s["start_ns"]

    for k in (0, 4):
        root, a, inner, b = spans[k:k + 4]
        assert root["self_ns"] == dur(root) - dur(a) - dur(b)
        assert a["self_ns"] == dur(a) - dur(inner)
        assert inner["self_ns"] == dur(inner) and b["self_ns"] == dur(b)
        assert a["self_ns"] >= 2e6 and inner["self_ns"] >= 2e6
        assert root["start_ns"] <= a["start_ns"] <= inner["start_ns"] \
            <= inner["end_ns"] <= a["end_ns"] <= b["start_ns"] \
            <= b["end_ns"] <= root["end_ns"]


def test_converted_times_lie_between_unix_clock_reads():
    tracing.start()
    before = time.time_ns()
    time.sleep(0.001)
    with tracing.span("x"):
        time.sleep(0.001)
    time.sleep(0.001)
    after = time.time_ns()
    (s,), _ = tracing.stop()
    assert before < s["start_ns"] < s["end_ns"] < after
    assert s["end_ns"] - s["start_ns"] >= 1e6


def _model():
    cfg = registry.get_smoke_config(ARCH)
    assert cfg.stacks[0].pattern == ("mla+mlp",) and \
        cfg.stacks[1].pattern == ("mla+moe",)
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(gen, cfg, device="cpu")
    # router biases that move the choice, so that the experts hit vary
    moe = params["stacks"][1][0]["ffn"]
    moe["e_bias"] = torch.randn(moe["e_bias"].shape, generator=gen) * 0.01
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    return cfg, params, tokens


@torch.inference_mode()
def _serve(cfg, params, tokens):
    """Prefill, then STEPS greedy decode steps: (every logits, caches)."""
    prefill = lm.prefill_step_fn(cfg, capacity=S + STEPS)
    decode = lm.decode_step_fn(cfg)
    logits, caches = prefill(params, {"tokens": tokens})
    out = [logits]
    for i in range(STEPS):
        nxt = out[-1][:, -1].argmax(-1, keepdim=True)
        logits, caches = decode(params, caches, nxt, S + i)
        out.append(logits)
    return out, caches


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_model_step_span_tree_counters_and_bit_identical_outputs():
    cfg, params, tokens = _model()
    want, want_caches = _serve(cfg, params, tokens)

    seen = []                    # the MoE's inputs, for the count by hand
    apply = L.moe_apply

    def capturing(p, c, x):
        seen.append(x.clone())
        return apply(p, c, x)

    L.moe_apply = capturing
    try:
        tracing.start()
        got, got_caches = _serve(cfg, params, tokens)
        spans, counters = tracing.stop()
    finally:
        L.moe_apply = apply

    for a, b in zip(want, got):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(want_caches), _leaves(got_caches)):
        assert torch.equal(a, b)

    def step(root):
        return (root, [
            ("embed", []),
            ("block", [("mixer.mla", [("attn.core", [])]),
                       ("ffn.mlp", [])]),
            ("block", [("mixer.mla", [("attn.core", [])]),
                       ("ffn.moe", [(n, []) for n in MOE])]),
            ("logits", [])])

    assert _tree(spans) == [step("lm.prefill")] + [step("lm.decode")] * STEPS
    roots = [s for s in spans if s["parent"] is None]
    assert [r["attrs"] for r in roots] == \
        [{"batch": B, "seq": S}] + [{"batch": B, "pos": S + i}
                                    for i in range(STEPS)]
    assert [r["step"] for r in roots] == list(range(1 + STEPS))
    for s in spans:
        root = s
        while root["parent"] is not None:
            root = spans[root["parent"]]
        assert s["step"] == root["step"]
    assert all(s["attrs"] == {} for s in spans if s["parent"] is not None)

    mc = cfg.moe
    moe = lm._index(params["stacks"][1][0], 0)["ffn"]   # the MoE layer
    hit = 0
    assert len(seen) == 1 + STEPS
    for x in seen:
        xf = x.reshape(-1, x.shape[-1])
        _, ids = L._route(moe, mc, xf)
        cap = L.moe_capacity(xf.shape[0], mc)
        _, slot_sorted, keep = L.moe_dispatch(ids, mc.num_experts, cap)
        hit += len(set((slot_sorted[keep] // cap).tolist()))
    # prefill's two MLA layers attend through chunked_attention; decode's
    # absorbed attention does not
    assert counters == {"moe.experts_hit": hit,
                        "moe.experts_read": mc.num_experts * (1 + STEPS),
                        "attn.chunked_calls": 2}
    # decode's B·K = 4 pairs reach at most 4 of the 8 experts
    assert hit < mc.num_experts * (1 + STEPS)


def test_chip_smokes_moe_helpers_unpack_moe_dispatch():
    """`chip_smoke.py`'s routing helpers (`_moe_drops`, `_kept`) call
    `moe_dispatch` as `moe_apply` does: around the same serve they count
    the drops `moe_dropped` counts, and `_kept`'s experts with a kept
    pair are the counter `moe.experts_hit`."""
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(root)
    cfg, params, tokens = _model()
    seen = []
    apply = L.moe_apply

    def capturing(p, c, x):
        seen.append(x.clone())
        return apply(p, c, x)

    L.moe_apply = capturing
    try:
        with cs._moe_drops() as drops:
            tracing.start()
            _serve(cfg, params, tokens)
            _, counters = tracing.stop()
    finally:
        L.moe_apply = apply
    mc = cfg.moe
    moe = lm._index(params["stacks"][1][0], 0)["ffn"]   # the MoE layer
    assert drops["dropped"] == [L.moe_dropped(moe, cfg, x) for x in seen]
    hit = 0
    for x in seen:
        xf = x.reshape(-1, x.shape[-1])
        _, ids = L._route(moe, mc, xf)
        kept = cs._kept(ids, mc.num_experts,
                        L.moe_capacity(xf.shape[0], mc))
        assert kept.shape == (xf.shape[0], mc.num_experts)
        hit += int(kept.any(0).sum())
    assert counters["moe.experts_hit"] == hit


# the profiler's device clock against the host's: profiled runs on the
# card read up to 0.2 ms off; a record on another clock reads seconds off
CLOCK_NS = 1_000_000


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


@pytest.mark.cuda
def test_launch_records_lie_inside_their_span_on_the_profilers_clock():
    """Under the profiler's CUDA activity alone, a `torch.mm` launched
    inside a span has its launch record within the span's converted
    interval, and the device records lie on the same clock: no kernel
    starts more than CLOCK_NS before its launch record. The profiler
    converts device times to the host clock once each time it starts,
    and some profiled runs on the card (3 of 42, and 5 of 16 first ones
    of a process) read every kernel 0.002-0.2 ms before its launch; the
    benchmark's reading moves such records to their launches. Every op
    runs once before, as the benchmark warms every shape before its
    slices."""
    _need_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(512, 512, device="cuda")
    torch.mm(a, a)
    torch.relu(a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):         # the profiler may miss its first records
            torch.relu(a)
        torch.cuda.synchronize()
        tracing.start()
        torch.relu(a)
        with tracing.span("mm"):
            torch.mm(a, a)
        torch.relu(a)
        torch.cuda.synchronize()
        spans, _ = tracing.stop()
    (mm,) = spans
    events = list(prof.profiler.kineto_results.events())
    launches = {e.correlation_id(): e for e in events
                if e.device_type() != DeviceType.CUDA
                and e.name().startswith("cu")}
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset"))]
    inside, outside = [], set()
    for k in kernels:
        launch = launches[k.correlation_id()]
        assert k.start_ns() > launch.start_ns() - CLOCK_NS, k.name()
        if mm["start_ns"] <= launch.start_ns() and \
                launch.start_ns() + launch.duration_ns() <= mm["end_ns"]:
            inside.append(k.name())
        else:
            outside.add(k.name())
    # the product's kernels (cuBLAS may take two) and none of the relus
    assert inside and not set(inside) & outside, (inside, outside)
    assert len(outside) == 1
