"""The plain references against the program at its smoke sizes, on the
CPU, in float32: prefill's last logits and caches, and decode steps
against the reference's forward over the same tokens. Each planted fault
in the reference (the causal mask off, another capacity, the shared
expert dropped, the published values read in place of the program's
departures) has to fail the comparison.

    PYTHONPATH=src:. python -m pytest -q portbench/tests
"""
from __future__ import annotations

import importlib.util
import os

import pytest
import torch

from portbench import compare, weights
from portbench.port_lm import model_config
from portbench.tests import tiny

TOL = 1e-4          # float32 on both sides: the order of operations only
B, S, STEPS = 2, 24, 4


def reference(name: str):
    path = os.path.join(tiny.PB, "reference", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plant(monkeypatch, ref, cfg: dict, fault: str) -> None:
    P = ref.P
    if fault == "causal_off":
        monkeypatch.setattr(P, "causal_mask",
                            lambda q, k: torch.ones(len(q), len(k),
                                                    dtype=torch.bool))
    elif fault == "capacity":
        cfg["departures"]["capacity_factor"]["runs"] = 1.25
    elif fault == "published":
        # the published values where the program departs from them
        cfg["departures"] = {"capacity_factor":
                             cfg["departures"]["capacity_factor"]}
    elif fault == "no_shared":
        moe = P.moe
        monkeypatch.setattr(P, "moe", lambda x, p, **kw: moe(
            x, {k: v for k, v in p.items() if k != "shared"}, **kw))


def errors(name: str, fault: str, monkeypatch) -> dict:
    """Largest relative errors of prefill logits, caches, and decode
    logits, program against reference."""
    from repro_torch.models import lm

    cfg = tiny.config(name)
    cfg["departures"]["capacity_factor"]["runs"] = 0.5   # pairs dropped
    cfg["port"]["moe"]["capacity_factor"] = 0.5
    mc = model_config(cfg["port"])
    params = weights.make(lm.init_abstract(mc), cfg["init"], 3, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (B, S + STEPS),
                           generator=torch.Generator().manual_seed(5))
    ref = reference(name)
    plant(monkeypatch, ref, cfg, fault)
    with torch.inference_mode():
        logits, caches = lm.prefill_step_fn(mc, S + STEPS)(
            params, {"tokens": tokens[:, :S]})
        decode = lm.decode_step_fn(mc)
        steps = []
        for t in range(S, S + STEPS):
            lg, caches = decode(params, caches, tokens[:, t:t + 1], t)
            steps.append(lg[:, 0])
        idx = torch.arange(B * S).view(B, S)
        want, want_caches = ref.forward(params, cfg, tokens[:, :S],
                                        [idx.reshape(-1)], idx[:, -1])
        L = S + STEPS
        idx = torch.arange(B * L).view(B, L)
        groups = [idx[:, :S].reshape(-1)] + [idx[:, t]
                                             for t in range(S, L)]
        want_dec, _ = ref.forward(params, cfg, tokens, groups,
                                  idx[:, S:].T.reshape(-1))
    return {"logits": compare.rel_err(logits[:, -1], want),
            "caches": compare.cache_err(compare.program_caches(caches),
                                        want_caches),
            "decode": compare.rel_err(torch.cat(steps), want_dec)}


@pytest.mark.parametrize("name", sorted(tiny.CONFIGS))
def test_reference_matches_the_program(name, monkeypatch):
    err = errors(name, "none", monkeypatch)
    assert max(err.values()) < TOL, err


@pytest.mark.parametrize("name,fault", [
    ("granite-moe-3b-a800m", "causal_off"),
    ("granite-moe-3b-a800m", "capacity"),
    ("granite-moe-3b-a800m", "published"),
    ("deepseek-v3-671b", "causal_off"),
    ("deepseek-v3-671b", "capacity"),
    ("deepseek-v3-671b", "no_shared"),
])
def test_a_planted_fault_fails_the_comparison(name, fault, monkeypatch):
    err = errors(name, fault, monkeypatch)
    assert max(err.values()) > 10 * TOL, err


def test_the_reference_refuses_what_it_does_not_compute():
    """deepseek's reference computes neither YaRN nor a group limit: read
    with the published values alone, it refuses rather than compare."""
    cfg = tiny.config("deepseek-v3-671b")
    del cfg["departures"]["rope_scaling"]
    with pytest.raises(ValueError, match="YaRN"):
        reference("deepseek-v3-671b").forward(
            {}, cfg, torch.zeros((1, 4), dtype=torch.long),
            [torch.arange(4)], torch.tensor([3]))
