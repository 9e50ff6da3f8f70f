"""Perf-iteration CLI: the port of `repro.launch.perf`.

Lowers one (arch × shape) cell with config overrides on the single-pod
mesh (a fake process group of 256 ranks; CPU only, no card) and reports
the probe-corrected roofline terms, so each hypothesis→change→measure
cycle is one command:

  PYTHONPATH=src python -m repro_torch.launch.perf --arch yi-34b \
      --shape prefill_32k --tag blockkv1024 --set block_kv=1024

The terms are priced with one H100's constants (`H100_HW`) unless
`--hw v5e` asks for the reference's TPU v5e (`ROOFLINE_HW`); both go
through the reference's `roofline_terms`. Results append to
experiments/perf/<arch>__<shape>.jsonl.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def parse_override(s: str):
    k, v = s.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("true", "True"):
        return k, True
    if v in ("false", "False"):
        return k, False
    return k, v


def main(argv=None) -> int:
    from repro_torch.launch.lowering import COLLECTIVES, params_bytes
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.models import SHAPES, registry
    from repro_torch.roofline.analysis import H100_HW, ROOFLINE_HW, \
        link_bw, roofline_terms
    from repro_torch.roofline.probes import FALLBACK, measure_corrected

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable)")
    ap.add_argument("--hw", default="h100", choices=["h100", "v5e"],
                    help="constants to price the terms with")
    ap.add_argument("--out", default="experiments/perf")
    args = ap.parse_args(argv)

    hw = H100_HW if args.hw == "h100" else ROOFLINE_HW
    cfg = registry.get_config(args.arch)
    overrides = dict(parse_override(s) for s in args.set)
    nested = {k: v for k, v in overrides.items() if "." in k}
    flat = {k: v for k, v in overrides.items() if "." not in k}
    if flat:
        cfg = dataclasses.replace(cfg, **flat)
    for k, v in nested.items():          # e.g. --set ssm.chunk=128
        outer, inner = k.split(".", 1)
        sub = getattr(cfg, outer)
        cfg = dataclasses.replace(cfg,
                                  **{outer: dataclasses.replace(
                                      sub, **{inner: v})})
    shape = SHAPES[args.shape]

    t0 = time.time()
    with fake_world(256):
        mesh = make_production_mesh(multi_pod=False)
        rec = measure_corrected(args.arch, cfg, shape, mesh, "pod16x16")
    c = rec["corrected"]
    row = roofline_terms(
        {"arch": args.arch, "shape": args.shape, "mesh": "pod16x16",
         "devices": 256, "params_bytes": params_bytes(cfg),
         "cost": {"flops": c["flops"], "bytes accessed": c["bytes"]},
         "collectives": {k: c[k] for k in COLLECTIVES}}, cfg, shape, hw)
    terms = {"compute_s": row.compute_s, "memory_s": row.memory_s,
             "collective_s": row.collective_s}
    dominant = max(terms, key=terms.get)
    out = {
        "tag": args.tag, "arch": args.arch, "shape": args.shape,
        "hw": args.hw, "overrides": overrides, "corrected": c, **terms,
        "dominant": dominant, "model_flops": row.model_flops,
        "useful_ratio": row.useful_ratio,
        # the part of the collective term that the ops the lowering ran
        # replicated cause, and those ops
        "collective_fallback_s": c[FALLBACK] / link_bw(hw),
        "fallbacks": rec["fallbacks"],
        "wall_s": round(time.time() - t0, 1),
    }
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.arch}__{args.shape}.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(out) + "\n")
    print(json.dumps({k: v for k, v in out.items() if k != "corrected"},
                     indent=1))
    print(f"terms ({args.hw}): compute={terms['compute_s']:.4f}s "
          f"memory={terms['memory_s']:.4f}s "
          f"collective={terms['collective_s']:.4f}s (of it from ops run "
          f"replicated {out['collective_fallback_s']:.4f}s) -> {dominant}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
