"""The control, and the faults of the timed path, at the tiny sizes on the
CPU.

- The control: the reference computed in fp8, put in the program's
  place, fails a limit set between its readings and the program's, as
  the limits of the real cells were set from `control.readings` on the
  card (`workloads/<cell>.json`).
- The faults: a run whose timed path is broken underneath comes out not
  correct under the real cells' limits (`workloads/<cell>.json`), once for each fault a serving cell can have: a step that
  leaves its state unchanged (prefill's caches, decode's cache writes),
  half the batch left out (its other half copied from the first), and a
  token or answer altered where it is produced. The exchange between
  chips has no fault here: every cell runs on one chip.

    PYTHONPATH=src:. python -m pytest -q portbench/tests
"""
from __future__ import annotations

import time

import pytest
import torch

from portbench import control, harness
from portbench.compare import verdict
from portbench.tests import tiny


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_the_control_fails_where_the_program_passes(tmp_path, cell):
    """At the tiny sizes the fp8 control's errors are smaller than at a
    cell's (~0.05 against ~0.12: wide tensors have heavier tails, so one
    scale a tensor rounds them more coarsely), so the real limits do not
    apply here. The rule that set them does: a limit between the program's
    largest and the control's smallest reading, over three seeds, passes
    the program and fails the control, and the control reads at least
    three times the program. A token gap of 0 on every seed is no
    reading to scale from; there the cache's error has to separate."""
    r = tiny.root(tmp_path, "bfloat16")
    runs = [control.readings(r, cell, seed, 0.2, "cpu")
            for seed in (2 ** 31 + 3, 7, 123456789)]
    assert {"program_correct", "control_correct"} <= set(runs[0])
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


def _twice(x):
    return torch.cat([x, x])


def _tree(f, t):
    if isinstance(t, dict):
        return {k: _tree(f, v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree(f, v) for v in t)
    return f(t)


def _alter(logits):
    """The least likely token of every row made its top one."""
    out = logits.clone()
    low = out.argmin(-1, keepdim=True)
    return out.scatter(-1, low, float(out.max()) + 1.0)


def faulty_prefill(real, fault):
    def make(cfg, capacity):
        fn = real(cfg, capacity)

        def prefill(params, batch):
            if fault == "half_batch":
                tok = batch["tokens"]
                half = {"tokens": tok[:tok.shape[0] // 2]}
                logits, caches = fn(params, half)
                return _twice(logits), _tree(
                    lambda t: torch.cat([t, t], dim=1), caches)
            logits, caches = fn(params, batch)
            if fault == "state_unchanged":
                caches = _tree(torch.zeros_like, caches)
            elif fault == "token_altered":
                logits = _alter(logits)
            return logits, caches
        return prefill
    return make


def faulty_decode(real, fault):
    def make(cfg):
        fn = real(cfg)

        def decode(params, caches, tokens, pos):
            if fault == "state_unchanged":
                saved = _tree(torch.clone, caches)
                logits, _ = fn(params, caches, tokens, pos)
                for s, c in zip(saved, caches):
                    for se, ce in zip(s, c):
                        for k in ce:
                            ce[k].copy_(se[k])
                return logits, caches
            if fault == "half_batch":
                h = tokens.shape[0] // 2
                half = _tree(lambda t: t[:, :h], caches)
                logits, _ = fn(params, half, tokens[:h], pos)
                for c in caches:
                    for ce in c:
                        for k in ce:
                            ce[k][:, h:] = ce[k][:, :h]
                return _twice(logits), caches
            logits, caches = fn(params, caches, tokens, pos)
            if fault == "token_altered" and pos % 5 == 2:   # a few a batch
                logits = _alter(logits)
            return logits, caches
        return decode
    return make


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            fault):
    from repro_torch.models import lm

    r = tiny.root(tmp_path, "float32")
    monkeypatch.setattr(lm, "prefill_step_fn",
                        faulty_prefill(lm.prefill_step_fn, fault))
    monkeypatch.setattr(lm, "decode_step_fn",
                        faulty_decode(lm.decode_step_fn, fault))
    res = harness.run_cell(r, cell, 2 ** 31 + 5, 0.3, False, "cpu",
                           time.perf_counter(), log=lambda *a: None)
    assert not res["correct"], res["checks"]
