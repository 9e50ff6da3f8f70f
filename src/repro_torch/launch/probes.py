"""Roofline probe CLI: the port of `repro.launch.probes`.

Runs the probe lowering of `repro_torch.roofline.probes` (one or two
layers a stack, one or two microbatches) for every (arch × applicable
shape) on the single-pod production mesh, a fake process group of 256
ranks, and stores experiments/probes/*.json. CPU only, no card.

  PYTHONPATH=src python -m repro_torch.launch.probes [--arch A] [--shape S]
"""
from __future__ import annotations

import argparse
import os
import time
import traceback


def main(argv=None) -> int:
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.models import SHAPES, registry, shape_applicable
    from repro_torch.roofline.probes import run_probes

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="experiments/probes")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    mesh_name = "pod16x16"
    archs = [args.arch] if args.arch else registry.list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    with fake_world(256):
        mesh = make_production_mesh(multi_pod=False)
        for arch in archs:
            cfg = registry.get_config(arch)
            for shape_name in shapes:
                ok, why = shape_applicable(cfg, SHAPES[shape_name])
                if not ok:
                    continue
                path = os.path.join(
                    args.out, f"{mesh_name}__{arch}__{shape_name}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[cached] {arch} {shape_name}")
                    continue
                t0 = time.time()
                try:
                    rec = run_probes(arch, shape_name, args.out, mesh,
                                     mesh_name)
                    c = rec["corrected"]
                    print(f"[ok] {arch} {shape_name} "
                          f"corr_flops={c['flops']:.3e}/dev "
                          f"coll={c['collective_total']:.3e}B/dev "
                          f"({time.time()-t0:.0f}s)")
                except Exception as e:                # noqa: BLE001
                    failures += 1
                    print(f"[FAIL] {arch} {shape_name}: "
                          f"{type(e).__name__}: {str(e)[:300]}")
                    traceback.print_exc()
    print(f"probes complete: {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
