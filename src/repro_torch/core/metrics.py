"""Evaluation metrics (paper §5).

* Kendall's τ rank correlation (within-kernel, averaged per program).
* MAPE — fusion task absolute-runtime accuracy.
* Tile-Size APE (Eq. 2) — how far the chosen-per-kernel tiles put the whole
  program from its per-kernel-optimal runtime.
"""
from __future__ import annotations

import numpy as np


def kendall_tau(preds, targets) -> float:
    """O(n²) Kendall tau-a; n per kernel is small (≤ hundreds here)."""
    p = np.asarray(preds, np.float64)
    t = np.asarray(targets, np.float64)
    n = len(p)
    if n < 2:
        return 0.0
    dp = np.sign(p[:, None] - p[None, :])
    dt = np.sign(t[:, None] - t[None, :])
    iu = np.triu_indices(n, k=1)
    concordant = np.sum(dp[iu] * dt[iu])
    total = n * (n - 1) / 2.0
    return float(concordant / total)


def mape(preds, targets, *, eps: float = 1e-12) -> float:
    p = np.asarray(preds, np.float64)
    t = np.asarray(targets, np.float64)
    return float(100.0 * np.mean(np.abs(p - t) / np.maximum(np.abs(t), eps)))


def tile_size_ape(per_kernel: list[dict]) -> float:
    """Eq. 2. per_kernel: [{'true': [runtime per config],
                            'pred': [score per config]}, ...] for one program.

    For each kernel pick argmin of predictions, compare its *true* runtime to
    the true optimum; normalize by the all-optimal program runtime.
    """
    num = 0.0
    den = 0.0
    for k in per_kernel:
        true = np.asarray(k["true"], np.float64)
        pred = np.asarray(k["pred"], np.float64)
        if len(true) == 0:
            continue
        chosen = float(true[int(np.argmin(pred))])
        best = float(true.min())
        num += abs(chosen - best)
        den += best
    return float(100.0 * num / max(den, 1e-30))


def program_kendall(per_kernel: list[dict]) -> float:
    """Mean within-kernel Kendall τ between predictions and targets."""
    taus = []
    for k in per_kernel:
        if len(k["true"]) >= 2:
            # τ between predicted and true runtimes (both ascending = good)
            taus.append(kendall_tau(k["pred"], k["true"]))
    return float(np.mean(taus)) if taus else 0.0


def geometric_mean(xs) -> float:
    xs = np.asarray(xs, np.float64)
    xs = np.maximum(xs, 1e-12)
    return float(np.exp(np.mean(np.log(xs))))
