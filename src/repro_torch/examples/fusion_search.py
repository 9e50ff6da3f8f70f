"""Fusion autotuning with a hardware budget (paper §7.3 / Fig. 5).

Compares simulated annealing on hardware alone vs. pre-screening with the
analytical model (stand-in for a trained learned model; see
`repro_torch.examples.train_cost_model` for the full learned pipeline).
Counterpart of examples/fusion_search.py: the same programs, budgets and
seeds, line for line the same output. Everything here runs on the host
(the simulator and the analytical model), so it takes no `--device`.

  PYTHONPATH=src python -m repro_torch.examples.fusion_search
"""
from __future__ import annotations

import argparse

from repro_torch.autotuner import simulated_annealing_fusion
from repro_torch.core.analytical import AnalyticalModel
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data.synthetic import generate_program

PROGRAMS = (("attention", 1), ("rnn", 2), ("norm", 0))


def search(prog, sim: TPUSimulator, am: AnalyticalModel):
    """(hardware-only result at a 60 s budget, model + hardware result at
    6 s) of one program."""
    def model_cost(kernels):
        return sum(am.predict(k) for k in kernels)
    r_hw = simulated_annealing_fusion(prog, sim, model_cost=None,
                                      hardware_budget_s=60,
                                      eval_seconds=2.0, seed=0)
    r_cm = simulated_annealing_fusion(prog, sim, model_cost=model_cost,
                                      hardware_budget_s=6, model_steps=300,
                                      eval_seconds=2.0, seed=0)
    return r_hw, r_cm


def report(prog, r_hw, r_cm) -> None:
    print(f"{prog.name}: default {r_hw.default_runtime:.3e}s")
    print(f"  HW-only  (60s budget): {r_hw.speedup:.3f}x speedup, "
          f"{r_hw.hardware_evals} hardware evals")
    print(f"  model+HW ( 6s budget): {r_cm.speedup:.3f}x speedup, "
          f"{r_cm.hardware_evals} hardware evals "
          f"({r_cm.model_evals} model evals on CPU)")


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    sim = TPUSimulator()
    am = AnalyticalModel()
    for fam, idx in PROGRAMS:
        prog = generate_program(fam, idx, seed=0)
        report(prog, *search(prog, sim, am))


if __name__ == "__main__":
    main()
