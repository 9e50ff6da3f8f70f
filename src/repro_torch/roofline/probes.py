"""Cost measurement by probe lowering: `repro.roofline.probes` over the
port's `lower_cell`.

The reference needs the probes because `compiled.cost_analysis()` counts
a while-loop body once, so a scanned 61-layer × 16-microbatch step
under-reports by orders of magnitude. The port unrolls its loops in
Python, so a cell's direct count is already complete; here the probes
are the fast path at full size, and the same algebra must give the
direct count (exactly for prefill/decode, within 1e-6 for train), which
is what shows the cost model true of the port.

Small UNROLLED probe variants of each cell are lowered on the same mesh
and the per-layer and per-microbatch costs solved algebraically. The
reference's probes hold one layer a stack; the port's hold b_s =
min(2, L_s) (`BASE_DEPTH`), since DTensor lowers a one-layer stack with
other layouts than a deeper one, and a stack no deeper than b_s needs no
probe of its own:

  train:    F(m, L_1..L_S) = O + m·(H + Σ_s L_s·C_s)
    P1  = F(1, all b_s)
    P3  = F(2, all b_s)                                   → O = 2·P1 − P3
    P2_s = F(1, b_s + 1, others b)     = P1 + C_s          → C_s
    corrected = O + m·(P1 − O + Σ_s (L_s−b_s)·C_s)

  prefill/decode: F(L) = O' + Σ L_s·C_s,  O' absorbed into P1:
    corrected = P1 + Σ_s (L_s−b_s)·C_s

  The port's train cell has three costs more, which the reference's
  model leaves out (U_s = Q_s = 0, R = 0 there gives its algebra):
    U_s   a layer's cost once a step: the optimizer's update of its
          params;
    Q_s   a microbatch's cost that grows with the square of a stack's
          depth: the backward of each layer's view of a stacked param
          scatters its gradient into a zero tensor of the whole stack;
    R(m)  the split of the global batch into microbatches
          (`lm.split_microbatches`), not linear in m: none at m = 1, a
          redistribution of the batch from its leading dim to the
          microbatch dim at m >= 2.
  F(m, L) = R(m) + O + Σ_s L_s·U_s + m·(H + Σ_s (L_s·C_s + L_s²·Q_s)).
  Each probe is taken less R at its own m (R lowered alone,
  `launch.lowering.lower_microbatch_split`), and one or two probes more
  a stack separate U_s, C_s and Q_s (Q_s = 0 where L_s = b_s + 1, which
  P2_s then holds whole):
    P4_s = F(2, b_s + 1, others b),  P5_s = F(1, b_s + 2, others b)
    a = P2_s − P1,  Q_s = (P5_s − P1 − 2a)/2,
    C_s = (P4_s − P3) − a − (2b_s+1)·Q_s,  U_s = a − C_s − (2b_s+1)·Q_s
    corrected = R(m) + O + Σ_s (L_s−b_s)·U_s
                + m·(P1 − O + Σ_s ((L_s−b_s)·C_s + (L_s²−b_s²)·Q_s))
  `workers` > 1 lowers the probes in processes of their own, each with a
  fake group of the mesh's shape.

Each probe is a real lowering on the production mesh, so the costs
include the collectives — the correction applies to flops, bytes AND
collective bytes uniformly. Probes use the single-pod mesh (the roofline
table is single-pod). The port adds the collective bytes of the ops the
lowering ran replicated (`FALLBACK`, under the same algebra) and each
collective's count, those ops summed over the probes, and the output
size and a peak-memory estimate, P1 + Σ_s (L_s−b_s)·(P2_s − P1), with no
microbatch factor.
"""
from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.models.config import ModelConfig, ShapeSpec, Stack

METRICS = ("flops", "bytes", "transcendentals", "all-gather", "all-reduce",
           "reduce-scatter", "all-to-all", "collective-permute")
# the port's: the collective bytes of the ops the lowering ran replicated
# (`LoweredCell.fallback_collectives`), a part of the five above, and the
# number of each collective
FALLBACK = "fallback-collectives"
COUNTS = tuple(f"{k} count" for k in METRICS[3:])
FALLBACK_AND_COUNTS = (FALLBACK,) + COUNTS


def _metrics(cost: dict, coll: dict, fallback: dict) -> dict:
    m = {
        "flops": float(cost.get("flops", 0.0)),
        "bytes": float(cost.get("bytes accessed", 0.0)),
        "transcendentals": float(cost.get("transcendentals", 0.0)),
    }
    for k in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute"):
        m[k] = float(coll.get(k, 0.0))
    m[FALLBACK] = float(sum(fallback.values()))
    for k in METRICS[3:]:
        m[f"{k} count"] = float(coll.get("_counts", {}).get(k, 0))
    return m


def _cell_metrics(cell) -> dict:
    return _metrics(cell.cost_analysis, cell.collective_bytes,
                    cell.fallback_collectives)


def _probe_cfg(cfg: ModelConfig, stack_repeats: list[int]) -> ModelConfig:
    stacks = tuple(Stack(s.pattern, r)
                   for s, r in zip(cfg.stacks, stack_repeats))
    return dataclasses.replace(cfg, stacks=stacks, scan_layers=False,
                               scan_microbatch=False)


def _probe_shape(shape: ShapeSpec, cfg: ModelConfig, m: int) -> ShapeSpec:
    if shape.kind != "train":
        return shape
    return ShapeSpec(shape.name, shape.seq_len, cfg.microbatch * m,
                     shape.kind)


# the probes' depth a stack (the reference's is one): one layer a stack
# is lowered with other layouts than two and more (DTensor plans a
# [1, ...] stacked param's views and gradients apart), so it is off the
# per-layer rate of a deeper stack
BASE_DEPTH = 2

_WORKER_MESH = []


def _worker_init(mesh_shape: tuple, axes: tuple) -> None:
    """A probe worker's fake process group and mesh, for its lifetime."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    world = 1
    for n in mesh_shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), world_size=world,
                            rank=0)
    _WORKER_MESH.append(make_mesh(mesh_shape, axes))


def _lower_job(job, *mesh) -> dict:
    """One probe ("cell", arch, cfg, shape, mesh name) or one microbatch
    split ("split", cfg, shape) lowered on `mesh` (a worker's own if none
    is given): its metrics, and a cell's fallbacks and memory fields."""
    mesh = mesh[0] if mesh else _WORKER_MESH[0]
    if job[0] == "split":
        from repro_torch.launch.lowering import lower_microbatch_split
        c = lower_microbatch_split(job[1], job[2], mesh)
        return {"metrics": _metrics(c.cost_analysis(), c.collective_bytes(),
                                    c.fallback_collective_bytes())}
    from repro_torch.launch.lowering import lower_cell
    _, arch, cfg, shape, mesh_name = job
    cell = lower_cell(arch, cfg, shape, mesh, mesh_name)
    mem = cell.memory_analysis
    return {"metrics": _cell_metrics(cell), "fallbacks": cell.fallbacks,
            "output_size_in_bytes": mem.output_size_in_bytes,
            "peak_memory_in_bytes": mem.peak_memory_in_bytes}


def _run_jobs(jobs: dict, mesh, workers: int, log) -> dict:
    """`jobs` (name -> job) lowered, in this process or in `workers`
    processes of their own, each with a fake group of `mesh`'s shape."""
    if workers <= 1:
        out = {}
        for name, job in jobs.items():
            log(f"  probe {name}")
            out[name] = _lower_job(job, mesh)
        return out
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init,
            initargs=(tuple(mesh.shape), tuple(mesh.mesh_dim_names))) as ex:
        futures = {name: ex.submit(_lower_job, job)
                   for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def measure_corrected(arch: str, cfg: ModelConfig, shape: ShapeSpec, mesh,
                      mesh_name: str, *, log=print, workers: int = 1) -> dict:
    """Returns {'corrected': {metric: per-device value}, 'probes': {...},
    'per_stack_layer': [...]}, and the port's: a train cell's per-layer
    costs a step ('per_stack_layer_step'), its microbatch split
    ('microbatch_split'), the ops run replicated summed over the probes
    ('fallbacks'), and the memory fields extrapolated over the layers
    ('memory'). `workers` > 1 lowers the probes in that many processes
    at once."""
    S = len(cfg.stacks)
    metrics = METRICS + FALLBACK_AND_COUNTS
    train = shape.kind == "train"
    # the probes' depth a stack: two layers, or the stack's own depth
    # where it has fewer; one layer more for a stack that is deeper
    base = [min(BASE_DEPTH, st.repeats) for st in cfg.stacks]
    deep = [s for s, st in enumerate(cfg.stacks) if st.repeats > base[s]]

    def plus(s, n=1):
        r = list(base)
        r[s] += n
        return r

    # a stack deeper by two or more gets a probe two layers deeper
    # (train): its gradient's cost grows with the square of its depth
    deeper = [s for s in deep if cfg.stacks[s].repeats > base[s] + 1]
    layout = {"P1": (base, 1)}
    layout.update({f"P2_{s}": (plus(s), 1) for s in deep})
    if train:
        layout["P3"] = (base, 2)
        layout.update({f"P4_{s}": (plus(s), 2) for s in deep})
        layout.update({f"P5_{s}": (plus(s, 2), 1) for s in deeper})
    jobs = {name: ("cell", arch, _probe_cfg(cfg, r),
                   _probe_shape(shape, cfg, m), mesh_name)
            for name, (r, m) in layout.items()}
    m_total = max(shape.global_batch // cfg.microbatch, 1) if train else 1
    if train:
        # the microbatch split is not linear in m (see
        # `lower_microbatch_split`): out of each probe, back at m_total
        for m in sorted({1, 2, m_total}):
            jobs[f"split{m}"] = ("split", cfg, shape if m == m_total
                                 else _probe_shape(shape, cfg, m))
    log(f"  {len(jobs)} probes of {arch}/{shape.name}")
    done = _run_jobs(jobs, mesh, workers, log)
    probes = {name: done[name]["metrics"] for name in layout}
    split = {m: done[f"split{m}"]["metrics"] for m in sorted({1, 2, m_total})
             } if train else {}

    zero = dict.fromkeys(metrics, 0.0)
    c_s, u_s, q_s = [zero] * S, [zero] * S, [zero] * S
    if train:
        lin = {n: {k: v[k] - split[layout[n][1]][k] for k in metrics}
               for n, v in probes.items()}
        for s in deep:
            # a layer's cost a step (U), and a microbatch's, linear (C)
            # and quadratic (Q) in the stack's depth
            b = base[s]
            a = {k: lin[f"P2_{s}"][k] - lin["P1"][k] for k in metrics}
            m2 = {k: lin[f"P4_{s}"][k] - lin["P3"][k] for k in metrics}
            if s in deeper:
                q_s[s] = {k: (lin[f"P5_{s}"][k] - lin["P1"][k] - 2 * a[k])
                          / 2 for k in metrics}
            c_s[s] = {k: m2[k] - a[k] - (2 * b + 1) * q_s[s][k]
                      for k in metrics}
            u_s[s] = {k: a[k] - c_s[s][k] - (2 * b + 1) * q_s[s][k]
                      for k in metrics}
    else:
        lin = probes
        for s in deep:
            c_s[s] = {k: lin[f"P2_{s}"][k] - lin["P1"][k] for k in metrics}

    corrected = {}
    for k in metrics:
        extra_layers = sum((st.repeats - b) * c[k]
                           + (st.repeats ** 2 - b * b) * q[k]
                           for st, b, c, q in zip(cfg.stacks, base, c_s, q_s))
        if train:
            O = max(2 * lin["P1"][k] - lin["P3"][k], 0.0)
            per_micro = lin["P1"][k] - O
            per_step = sum((st.repeats - b) * u[k]
                           for st, b, u in zip(cfg.stacks, base, u_s))
            corrected[k] = (O + per_step
                            + m_total * (per_micro + extra_layers)
                            + split[m_total][k])
        else:
            corrected[k] = lin["P1"][k] + extra_layers

    corrected["collective_total"] = sum(
        corrected[k] for k in ("all-gather", "all-reduce", "reduce-scatter",
                               "all-to-all", "collective-permute"))
    fallbacks = {}
    for name in layout:
        for op, n in done[name]["fallbacks"].items():
            fallbacks[op] = fallbacks.get(op, 0) + n

    # the outputs (params, optimizer state, cache) and the port's peak
    # estimate grow by layer and not by microbatch: the microbatches run
    # one after another
    def by_layers(field):
        p1 = done["P1"][field]
        return int(p1 + sum((cfg.stacks[s].repeats - base[s])
                            * (done[f"P2_{s}"][field] - p1) for s in deep))

    memory = {f: by_layers(f) for f in ("output_size_in_bytes",
                                        "peak_memory_in_bytes")}
    return {"corrected": corrected, "probes": probes,
            "per_stack_layer": c_s, "per_stack_layer_step": u_s,
            "per_stack_layer_quadratic": q_s,
            "microbatch_split": {str(m): v for m, v in split.items()},
            "fallbacks": fallbacks, "memory": memory}


def run_probes(arch: str, shape_name: str, out_dir: str, mesh,
               mesh_name: str) -> dict:
    from repro_torch.models import SHAPES, registry
    cfg = registry.get_config(arch)
    shape = SHAPES[shape_name]
    rec = measure_corrected(arch, cfg, shape, mesh, mesh_name)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{mesh_name}__{arch}__{shape_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec
