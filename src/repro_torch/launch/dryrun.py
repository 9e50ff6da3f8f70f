"""Multi-pod dry-run CLI: the port of `repro.launch.dryrun`.

For every (architecture × applicable input shape × mesh) cell: lower the
step on meta DTensors over the production mesh (`launch.lowering`), print
its per-device memory (the local shards of its arguments and outputs)
and cost (FLOPs, bytes, collective bytes), and persist a JSON record
under experiments/dryrun/ that the roofline pass reads. Runs on the CPU
and needs no card: each mesh gets its own fake process group of 256 or
512 ranks (`launch.mesh.fake_world`), where the reference forces 512 XLA
host devices.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun               # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi  # 2-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-v3-671b \
      --shape train_4k --mesh single

Each cell's cost comes from the probe lowering
(`roofline.probes.measure_corrected`: one or two layers a stack, one or
two microbatches, extrapolated), which the tests hold equal to the whole
cell's count; `--direct` lowers the whole cell instead, every layer and
microbatch unrolled (minutes to hours at full size, see PERF.md). Both
write the same keys: the argument and alias sizes from the cell's specs
(the local shards), the output size and the peak estimate from the
lowering (extrapolated over the layers by the probes), the ops the
lowering ran replicated (`fallbacks`) and the collective bytes they
cause (`fallback_collective_bytes`, a part of `collectives`). The record
says which route (`"cost_from"`).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback


def argument_bytes(cfg, shape, mesh) -> tuple[dict, dict]:
    """The cell's argument and alias (donated) sizes a device from its
    specs alone, with no step run, as `lower_cell` reports them, and its
    argument bytes by input: params, then the optimizer state (train) or
    the cache (decode), then the batch."""
    from repro_torch.launch.lowering import build_arg_specs
    from repro_torch.sharding.partition import spec_bytes
    args, in_sh, donate = build_arg_specs(cfg, shape, mesh)
    names = {"train": ("params", "optimizer", "batch"),
             "prefill": ("params", "batch"),
             "decode": ("params", "cache", "tokens")}[shape.kind]
    parts = {n: spec_bytes(a, s, mesh)
             for n, a, s in zip(names, args, in_sh)}
    alias = sum(parts[names[i]] for i in donate)
    return ({"argument_size_in_bytes": sum(parts.values()),
             "alias_size_in_bytes": alias}, parts)


def lower_record(arch, cfg, shape, mesh, mesh_name, *, direct=False,
                 workers=1) -> dict:
    """One cell's `ok` record (the reference's keys, and the port's)."""
    import math

    from repro_torch.launch.lowering import COLLECTIVES, lower_cell, \
        params_bytes
    from repro_torch.roofline.probes import FALLBACK, measure_corrected

    t0 = time.time()
    memory, parts = argument_bytes(cfg, shape, mesh)
    if direct:
        cell = lower_cell(arch, cfg, shape, mesh, mesh_name)
        mem = vars(cell.memory_analysis)
        cost = {k: float(v) for k, v in cell.cost_analysis.items()}
        collectives = cell.collective_bytes
        fallbacks = cell.fallbacks
        fallback_bytes = float(sum(cell.fallback_collectives.values()))
    else:
        rec = measure_corrected(arch, cfg, shape, mesh, mesh_name,
                                log=lambda *a: None, workers=workers)
        c = rec["corrected"]
        mem = rec["memory"]
        cost = {"flops": c["flops"], "bytes accessed": c["bytes"],
                "transcendentals": c["transcendentals"]}
        collectives = {k: c[k] for k in COLLECTIVES if c[k]}
        collectives["_counts"] = {k: int(c[f"{k} count"])
                                  for k in COLLECTIVES if c[f"{k} count"]}
        fallbacks = rec["fallbacks"]
        fallback_bytes = c[FALLBACK]
    peak = int(mem["peak_memory_in_bytes"])
    memory.update(output_size_in_bytes=int(mem["output_size_in_bytes"]),
                  temp_size_in_bytes=peak - memory["argument_size_in_bytes"],
                  peak_memory_in_bytes=peak)
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "devices": math.prod(mesh.shape),
        "cost_from": "direct" if direct else "probes",
        "compile_s": round(time.time() - t0, 1),
        "params_bytes": params_bytes(cfg),
        "memory": memory,
        "memory_estimated": ["temp_size_in_bytes", "peak_memory_in_bytes"],
        "arguments": parts,
        "cost": cost,
        "collectives": collectives,
        "fallbacks": fallbacks,
        "fallback_collective_bytes": fallback_bytes,
    }


def main(argv=None) -> int:
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.models import SHAPES, registry, shape_applicable

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None, help="one shape (default all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--fail-fast", action="store_true")
    ap.add_argument("--direct", action="store_true",
                    help="lower each cell whole, not by probes")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes that lower a cell's probes at once")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else registry.list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for multi_pod in meshes:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            for arch in archs:
                cfg = registry.get_config(arch)
                for shape_name in shapes:
                    shape = SHAPES[shape_name]
                    ok, why = shape_applicable(cfg, shape)
                    path = os.path.join(
                        args.out, f"{mesh_name}__{arch}__{shape_name}.json")
                    if not ok:
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "status": "skipped",
                               "reason": why}
                        with open(path, "w") as f:
                            json.dump(rec, f, indent=1)
                        print(f"[skip] {mesh_name} {arch} {shape_name}: "
                              f"{why}")
                        continue
                    if args.skip_existing and os.path.exists(path):
                        with open(path) as f:
                            prev = json.load(f)
                        if prev.get("status") == "ok":
                            print(f"[cached] {mesh_name} {arch} "
                                  f"{shape_name}")
                            continue
                    try:
                        rec = lower_record(arch, cfg, shape, mesh,
                                           mesh_name, direct=args.direct,
                                           workers=args.workers)
                        print(f"[ok]   {mesh_name} {arch} {shape_name} "
                              f"({rec['cost_from']}) "
                              f"lower={rec['compile_s']}s "
                              f"flops={rec['cost'].get('flops', 0):.3e}")
                        print(f"       memory: {rec['memory']}")
                    except Exception as e:            # noqa: BLE001
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "status": "error",
                               "error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()[-4000:]}
                        failures.append((mesh_name, arch, shape_name, e))
                        print(f"[FAIL] {mesh_name} {arch} {shape_name}: "
                              f"{type(e).__name__}: {str(e)[:400]}")
                        if args.fail_fast:
                            with open(path, "w") as f:
                                json.dump(rec, f, indent=1)
                            return 1
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
    print(f"\ndry-run complete: {len(failures)} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
