"""The flywheel driver: k measure→append→fine-tune→search rounds.
Counterpart of `repro.flywheel.loop`, on the model's device.

Each round spends an equal slice of one shared `BudgetMeter` on the
candidates the current model is least certain about
(`AcquisitionEstimator.acquire`), appends the paid measurements to the
corpus store as a chain-verified delta shard (`MeasurementLog.flush_to`
→ `CorpusWriter.append_delta`), and warm-start fine-tunes the model on
the base+delta stream (`fine_tune` from the previous round's
checkpoint). Selection quality is reported as deploy-and-observe
regret: per kernel, the best of (everything measured so far, the
current model's top pick run once) against the exhaustive oracle
optimum — the same rule a static model is scored with at equal budget,
which is the `bench_flywheel` gate (`chip_smoke.py`'s `[flywheel]`
phase on the port).

Scoring and acquisition run under the `model_cfg` given (the
aggregation kernels on, if it asks for them); each round's fine-tune
trains the same weights through the plain route (`fine_tune`).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np

from repro_torch.core.model import CostModel, CostModelConfig
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data.store import StreamingCorpus
from repro_torch.data.tile_dataset import enumerate_tiles
from repro_torch.flywheel.log import MeasurementLog
from repro_torch.flywheel.retrain import fine_tune
from repro_torch.search import (
    AcquisitionEstimator,
    BudgetMeter,
    HardwareEstimator,
    LearnedEstimator,
)
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.optim import adamw_init, tree_leaves


@dataclass
class FlywheelConfig:
    rounds: int = 3
    budget_evals: int = 48        # TOTAL hardware evals across all rounds
    eval_seconds: float = 2.0     # BudgetMeter cost of one eval
    finetune_steps: int = 120
    warmup_steps: int = 20
    lr: float = 1e-3
    mc_samples: int = 8           # MC-dropout passes per score
    spread: str = "kernel"        # acquisition routing policy
    # LCB exploitation/exploration balance: candidates are acquired by
    # lowest (mean - kappa * std). None = pure highest-variance routing
    # (too risky: it happily burns the whole budget on candidates the
    # mean already calls slow). kappa must be calibrated to the variance
    # head: MC-dropout stds run ~3-5x smaller than the model's actual
    # error margins, so with kappa ~ 1 the kappa*std term never
    # overturns a confident mean and LCB degenerates into the static
    # ranking — the loop then measures exactly the static plan's
    # candidates and can only tie it. 6.0 scales the std up to where
    # the plan explores just past the static top-k frontier (which is
    # precisely where a kernel the static model ranks badly keeps its
    # true best), while staying mean-anchored enough not to waste evals
    # on predicted-slow outliers.
    kappa: float | None = 6.0
    # Oversampling of the measured target sweeps during fine-tune: each
    # multi-config sweep the log has accumulated appears `delta_boost`
    # times in the round's training stream (once via the store's chained
    # view + boost-1 extra copies under alias program names). The alias
    # is the load-bearing part: `TileBatchSampler` balances draws
    # per-PROGRAM, so extra records filed under the same program change
    # nothing — each alias is its own draw slot, multiplying the
    # target's draw probability. Without it, uniform program sampling
    # starves the rank loss of exactly the within-sweep contrast the
    # round just paid for (the target programs are a sliver of the
    # corpus), and the fine-tuned model's top pick never moves off the
    # static model's.
    delta_boost: int = 4
    seed: int = 0
    kernels_per_batch: int = 4
    configs_per_kernel: int = 8
    max_configs: int = 24         # candidate tiles enumerated per kernel


@dataclass
class RoundStats:
    round: int
    measured: int                 # hardware evals charged this round
    delta_records: int            # records in the appended delta (0 = none)
    regret: float                 # deploy-and-observe regret after round
    train_loss: float
    # the raw (group, candidate, runtime) acquisition stream, in charge
    # order — what a from-scratch rebuild of this round's delta replays
    acquired: list = None


@dataclass
class FlywheelResult:
    rounds: list[RoundStats]
    params: CostModel             # final fine-tuned model
    truth: list[np.ndarray]       # oracle runtimes per group (eval only)
    measured: list[dict]          # per group: {candidate: runtime}
    evals_charged: int
    regret0: float                # static (round-0) model, model-pick only

    @property
    def final_regret(self) -> float:
        return self.rounds[-1].regret if self.rounds else self.regret0


def deploy_regret(truth, scores, measured) -> float:
    """Mean relative regret under deploy-and-observe selection: per
    group, run the model's top pick once and keep the best runtime seen
    (that pick plus everything already measured)."""
    regs = []
    for t, s, m in zip(truth, scores, measured):
        cand = [float(t[int(np.argmin(s))])]
        cand.extend(float(t[ci]) for ci in m)
        regs.append(min(cand) / float(np.min(t)) - 1.0)
    return float(np.mean(regs))


def static_plan(scores, budget: int) -> list[dict]:
    """The uniform-exploitation baseline plan: round-robin over groups,
    each group measuring its next-best candidate by static model score,
    until `budget` evals are allotted. Returns per-group candidate sets
    (the `measured` shape `deploy_regret` takes)."""
    orders = [list(np.argsort(np.asarray(s), kind="stable"))
              for s in scores]
    picks: list[set] = [set() for _ in scores]
    allotted, depth = 0, 0
    while allotted < budget and any(depth < len(o) for o in orders):
        for gi, o in enumerate(orders):
            if allotted >= budget:
                break
            if depth < len(o):
                picks[gi].add(int(o[depth]))
                allotted += 1
        depth += 1
    return [dict.fromkeys(p) for p in picks]


def run_flywheel(sim: TPUSimulator, store_dir: str, target_kernels,
                 params0: CostModel, model_cfg: CostModelConfig, normalizer,
                 cfg: FlywheelConfig, *, ckpt_dir: str,
                 tiles=None) -> FlywheelResult:
    """Run `cfg.rounds` flywheel rounds against `store_dir`.

    `target_kernels` are the (untiled) kernels being tuned; candidates
    are their `enumerate_tiles` sweeps (or `tiles`, a parallel list of
    tile lists). `params0` is the static round-0 model (a `CostModel`:
    every round fine-tunes and scores on its device); its checkpoint
    chain grows under `ckpt_dir` (``round-00`` holds params0, each round
    r fine-tunes from ``round-<r>`` into ``round-<r+1>``). The exhaustive
    oracle pass used for regret reporting is an *eval harness* — it never
    touches the meter, exactly like the autotuners' `exhaustive_truth`.
    """
    target_kernels = list(target_kernels)
    if tiles is None:
        tiles = [enumerate_tiles(k, max_configs=cfg.max_configs)
                 for k in target_kernels]
    groups = [[k.with_tile(t) for t in ts]
              for k, ts in zip(target_kernels, tiles)]
    truth = [np.array([sim.measure(g) for g in grp], np.float64)
             for grp in groups]                      # oracle: uncharged

    meter = BudgetMeter(budget_s=cfg.budget_evals * cfg.eval_seconds,
                        eval_seconds=cfg.eval_seconds)
    mlog = MeasurementLog("tile")
    hw = HardwareEstimator(sim, meter=meter, log=mlog)

    cur_ckpt = os.path.join(ckpt_dir, "round-00")
    tree0 = params0.tree()
    ckpt_lib.save_checkpoint(cur_ckpt, 0,
                             {"params": tree0, "opt": adamw_init(tree0)},
                             meta={"flywheel_round": 0})
    cur_params = params0

    static = LearnedEstimator.from_params(
        params0, model_cfg, normalizer, max_nodes=model_cfg.max_nodes,
        cache_capacity=0)
    scores0 = static.estimate_groups(groups)
    regret0 = deploy_regret(truth, scores0, [()] * len(groups))

    measured: list[dict] = [{} for _ in groups]
    exclude: set[tuple[int, int]] = set()
    rounds: list[RoundStats] = []
    for r in range(cfg.rounds):
        acq = AcquisitionEstimator(
            cur_params, model_cfg, normalizer, samples=cfg.mc_samples,
            seed=cfg.seed + r, max_nodes=model_cfg.max_nodes)
        share = -(-cfg.budget_evals // cfg.rounds)   # ceil split
        triples = acq.acquire(groups, hw, budget=share,
                              spread=cfg.spread, exclude=exclude,
                              kappa=cfg.kappa)
        for gi, ci, rt in triples:
            measured[gi][ci] = rt
            exclude.add((gi, ci))
        manifest = mlog.flush_to(store_dir, min_configs=1,
                                 note=f"flywheel round {r}")
        n_delta = manifest["stats"]["records"] if manifest else 0
        chained = StreamingCorpus.open(store_dir).with_deltas()
        train_recs = chained
        if cfg.delta_boost > 1:
            sweeps = mlog.records(min_configs=2)
            if sweeps:
                train_recs = list(chained) + [
                    dataclasses.replace(s, program=f"{s.program}~b{j}")
                    for j in range(1, cfg.delta_boost)
                    for s in sweeps]
        next_ckpt = os.path.join(ckpt_dir, f"round-{r + 1:02d}")
        ft = fine_tune(train_recs, normalizer, model_cfg,
                       warm_start_dir=cur_ckpt, steps=cfg.finetune_steps,
                       ckpt_dir=next_ckpt, lr=cfg.lr,
                       warmup_steps=cfg.warmup_steps, seed=cfg.seed + r,
                       kernels_per_batch=cfg.kernels_per_batch,
                       configs_per_kernel=cfg.configs_per_kernel,
                       device=params0.device)
        if os.environ.get("REPRO_FLYWHEEL_DEBUG"):
            delta = sum(float((a.detach() - b.detach()).abs().sum())
                        for a, b in zip(tree_leaves(cur_params.tree()),
                                        tree_leaves(ft.params.tree())))
            n_rec = len(train_recs) if train_recs is not chained \
                else len(chained)
            progs = {getattr(r, "program", "?") for r in (
                train_recs if train_recs is not chained else [])}
            print(f"    [fw-dbg] round {r}: sweeps="
                  f"{len(mlog.records(min_configs=2))} train_recs={n_rec} "
                  f"alias_progs={sum('~b' in p for p in progs)} "
                  f"param_delta={delta:.3e} "
                  f"train_loss={ft.final_train_loss:.4f}")
        cur_params, cur_ckpt = ft.params, next_ckpt
        learned = LearnedEstimator.from_params(
            cur_params, model_cfg, normalizer,
            max_nodes=model_cfg.max_nodes, cache_capacity=0)
        scores = learned.estimate_groups(groups)
        if os.environ.get("REPRO_FLYWHEEL_DEBUG"):
            picks = [int(np.argmin(s)) for s in scores]
            picks0 = [int(np.argmin(s)) for s in scores0]
            print(f"    [fw-dbg] round {r}: picks {picks} "
                  f"(static {picks0})")
        rounds.append(RoundStats(
            round=r, measured=len(triples), delta_records=n_delta,
            regret=deploy_regret(truth, scores, measured),
            train_loss=ft.final_train_loss, acquired=list(triples)))
    return FlywheelResult(rounds=rounds, params=cur_params, truth=truth,
                          measured=measured, evals_charged=meter.evals,
                          regret0=regret0)
