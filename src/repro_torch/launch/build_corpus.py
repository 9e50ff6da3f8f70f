"""Corpus-builder CLI: fan corpus generation across worker processes into
a sharded on-disk store (repro_torch.data.store; docs/DATA.md). A copy of
`repro.launch.build_corpus`: for the same arguments both write the same
store, down to the manifest hash.

One *task* is one program — a synthetic family instance from
`data.synthetic.corpus_plan` or one jaxpr-imported architecture from the
model zoo. Each worker generates its programs, runs the fusion machinery
and the simulator oracle, and ships serialized records back; the parent
merges them **in task order** into one `CorpusWriter` per requested kind,
deduplicating by content hash. Because every per-task build is
partition-invariant (`build_tile_records` / `build_fusion_records` seed
from content, the simulator's noise is content-keyed), the resulting
manifest hash does not depend on ``--workers`` — and rebuilding an
unchanged spec is detected up front and skipped (a manifest-hash no-op;
``--force`` overrides).

  PYTHONPATH=src python -m repro_torch.launch.build_corpus \\
      --out experiments/corpora/v1 --kind tile fusion \\
      --programs 48 --seed 0 --workers 4

Train from the result:

  PYTHONPATH=src python -m repro_torch.launch.train cost-model \\
      --from-store experiments/corpora/v1/tile --task tile

Workers fork/spawn from this module; synthetic generation and the oracle
are pure numpy, so neither it nor its workers import torch. The default
``--mp-context auto`` forks when that is safe (CUDA not initialised in
the parent: a child forked after it cannot use the card) and spawns
otherwise. ``--import-archs`` adds one task per model-zoo architecture,
its smoke-scale `loss_fn` traced into a program by
`repro_torch.core.hlo_import` on ``--device`` (cuda by default, cpu on
request; the program is the same on both):

  PYTHONPATH=src python -m repro_torch.launch.build_corpus \\
      --out /tmp/corp --programs 4 --import-archs yi-9b mamba2-2.7b \\
      --device cpu
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import time

from repro_torch.data.store import (
    CorpusWriter,
    StreamingCorpus,
    load_manifest,
    pack_record,
    spec_hash,
)
from repro_torch.data.synthetic import corpus_plan

BUILDER_VERSION = 1
DEFAULT_TILE = {"max_configs_per_kernel": 24, "max_kernel_nodes": 64,
                "min_configs": 2}
DEFAULT_FUSION = {"configs_per_program": 12, "max_kernel_nodes": 64}


# ----------------------------------------------------------------------------
# Worker side
# ----------------------------------------------------------------------------
def _build_program(task: tuple, seed: int, device: str):
    """Materialize one task's pre-fusion program graph."""
    if task[0] == "synthetic":
        from repro_torch.data.synthetic import generate_program
        _, family, idx = task
        return generate_program(family, idx, seed)
    if task[0] == "import":
        from repro_torch.core.hlo_import import import_arch_program
        return import_arch_program(task[1], device=device)
    raise ValueError(f"unknown task {task!r}")


def _run_task(args: tuple) -> dict:
    """Build all requested kinds' records for one program; returns packed
    (JSON-able) records so pickling back to the merger is cheap and the
    parent never re-hashes kernels."""
    task, kinds, seed, tile_opts, fusion_opts, device = args
    from repro_torch.core.simulator import TPUSimulator
    from repro_torch.data.fusion import apply_fusion, default_fusion
    from repro_torch.data.fusion_dataset import build_fusion_records
    from repro_torch.data.tile_dataset import build_tile_records

    sim = TPUSimulator()
    program = _build_program(task, seed, device)
    out: dict = {"task": task, "program": program.program}
    if "tile" in kinds:
        kernels = apply_fusion(program, default_fusion(program))
        recs = build_tile_records(kernels, sim, seed=seed, **tile_opts)
        out["tile"] = [pack_record("tile", r) for r in recs]
    if "fusion" in kinds:
        recs = build_fusion_records(program, sim, seed=seed, **fusion_opts)
        out["fusion"] = [pack_record("fusion", r) for r in recs]
    return out


# ----------------------------------------------------------------------------
# Parent side
# ----------------------------------------------------------------------------
def _pick_context(requested: str) -> str:
    if requested != "auto":
        return requested
    methods = multiprocessing.get_all_start_methods()
    # fork is cheap (workers inherit numpy, skip re-import) but breaks
    # the children once the parent has initialised CUDA
    torch = sys.modules.get("torch")
    if "fork" in methods and not (torch is not None
                                  and torch.cuda.is_initialized()):
        return "fork"
    return "spawn"


def make_spec(kind: str, *, programs: int, seed: int,
              import_archs: tuple[str, ...] = (),
              shard_records: int = 128,
              tile_opts: dict | None = None,
              fusion_opts: dict | None = None) -> dict:
    """The deterministic identity of a build — what the manifest records
    and what the no-op rebuild check compares. Everything that can change
    the output bytes is in here (incl. shard_records: it changes the
    shard partitioning, hence the manifest). Import archs are sorted —
    the builder schedules them in the same sorted order, so CLI argument
    order cannot change the record order either."""
    spec = {"builder_version": BUILDER_VERSION, "kind": kind,
            "programs": int(programs), "seed": int(seed),
            "shard_records": int(shard_records),
            "import_archs": sorted(import_archs)}
    if kind == "tile":
        spec["tile"] = dict(DEFAULT_TILE, **(tile_opts or {}))
    else:
        spec["fusion"] = dict(DEFAULT_FUSION, **(fusion_opts or {}))
    return spec


def build_corpus(out_dir: str, *, kinds=("tile", "fusion"), programs: int = 48,
                 seed: int = 0, import_archs: tuple[str, ...] = (),
                 workers: int = 1, shard_records: int = 128,
                 tile_opts: dict | None = None,
                 fusion_opts: dict | None = None, force: bool = False,
                 mp_context: str = "auto", quiet: bool = False,
                 device: str = "cuda") -> dict:
    """Build one store per kind under `out_dir`/<kind>. Returns
    {kind: manifest}. Skips kinds whose stored spec already matches
    (manifest-hash no-op) unless `force`. `import_archs` are traced on
    `device`."""
    log = (lambda *a: None) if quiet else \
        (lambda *a: print(*a, file=sys.stderr))
    specs = {k: make_spec(k, programs=programs, seed=seed,
                          import_archs=tuple(import_archs),
                          shard_records=shard_records,
                          tile_opts=tile_opts, fusion_opts=fusion_opts)
             for k in kinds}
    manifests: dict[str, dict] = {}
    todo = []
    for kind in kinds:
        path = os.path.join(out_dir, kind)
        existing = load_manifest(path)
        if (existing is not None and not force
                and existing["spec_hash"] == spec_hash(specs[kind])):
            log(f"[build_corpus] {path}: spec unchanged "
                f"(hash {existing['manifest_hash'][:12]}…) — no-op")
            manifests[kind] = existing
        else:
            todo.append(kind)
    if not todo:
        return manifests

    tasks = [("synthetic", fam, idx) for fam, idx in corpus_plan(programs)]
    tasks += [("import", arch) for arch in sorted(import_archs)]
    job_args = [(t, tuple(todo), seed,
                 specs.get("tile", {}).get("tile", DEFAULT_TILE),
                 specs.get("fusion", {}).get("fusion", DEFAULT_FUSION),
                 device)
                for t in tasks]
    writers = {k: CorpusWriter(os.path.join(out_dir, k), k, spec=specs[k],
                               shard_records=shard_records)
               for k in todo}
    t0 = time.perf_counter()
    try:
        if workers <= 1:
            results = map(_run_task, job_args)
            _merge(results, writers, len(tasks), log)
        else:
            ctx = multiprocessing.get_context(_pick_context(mp_context))
            with ctx.Pool(processes=workers) as pool:
                # imap (not imap_unordered): merge order == task order, so
                # the store is identical no matter how many workers ran
                _merge(pool.imap(_run_task, job_args), writers,
                       len(tasks), log)
        for kind in todo:
            manifests[kind] = writers[kind].finalize()
            s = manifests[kind]["stats"]
            log(f"[build_corpus] {out_dir}/{kind}: {s['records']} records "
                f"({s['samples']} samples, {s['duplicates_dropped']} dupes "
                f"dropped, {len(manifests[kind]['shards'])} shards) "
                f"in {time.perf_counter() - t0:.1f}s "
                f"hash={manifests[kind]['manifest_hash'][:12]}…")
    except BaseException:
        for w in writers.values():
            w.abort()
        raise
    return manifests


def _merge(results, writers: dict, n_tasks: int, log) -> None:
    for i, res in enumerate(results):
        for kind, w in writers.items():
            for packed in res.get(kind, ()):
                w.add_packed(packed)
        if (i + 1) % 10 == 0 or i + 1 == n_tasks:
            log(f"[build_corpus] merged {i + 1}/{n_tasks} programs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.build_corpus",
        description="Build a sharded on-disk corpus store (docs/DATA.md).")
    ap.add_argument("--out", required=True,
                    help="store root; one subdir per kind is created")
    ap.add_argument("--kind", nargs="+", default=["tile", "fusion"],
                    choices=["tile", "fusion"])
    ap.add_argument("--programs", type=int, default=48,
                    help="synthetic programs (corpus_plan schedule)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--import-archs", nargs="*", default=[],
                    help="model-zoo architectures to import (their smoke "
                         "loss_fn traced by core.hlo_import)")
    ap.add_argument("--device", default="cuda",
                    help="where --import-archs traces: cuda (default; "
                         "raises without a card) or cpu")
    ap.add_argument("--workers", type=int,
                    default=max(os.cpu_count() or 1, 1))
    ap.add_argument("--shard-records", type=int, default=128)
    ap.add_argument("--tile-configs", type=int,
                    default=DEFAULT_TILE["max_configs_per_kernel"])
    ap.add_argument("--fusion-configs", type=int,
                    default=DEFAULT_FUSION["configs_per_program"])
    ap.add_argument("--max-kernel-nodes", type=int, default=64)
    ap.add_argument("--force", action="store_true",
                    help="rebuild even if the stored spec matches")
    ap.add_argument("--mp-context", default="auto",
                    choices=["auto", "fork", "spawn"])
    ap.add_argument("--verify", action="store_true",
                    help="re-open and checksum-verify the result")
    args = ap.parse_args(argv)

    manifests = build_corpus(
        args.out, kinds=tuple(args.kind), programs=args.programs,
        seed=args.seed, import_archs=tuple(args.import_archs),
        workers=args.workers, shard_records=args.shard_records,
        tile_opts={"max_configs_per_kernel": args.tile_configs,
                   "max_kernel_nodes": args.max_kernel_nodes},
        fusion_opts={"configs_per_program": args.fusion_configs,
                     "max_kernel_nodes": args.max_kernel_nodes},
        force=args.force, mp_context=args.mp_context, device=args.device)
    for kind, m in manifests.items():
        if args.verify:
            StreamingCorpus.open(os.path.join(args.out, kind), verify=True)
        print(f"{kind}: {m['stats']['records']} records "
              f"manifest_hash={m['manifest_hash']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
