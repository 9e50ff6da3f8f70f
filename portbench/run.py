"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` `breakdown`, and last `checks`, each compared number
beside its limit (also the last lines of standard error). Exits 2,
printing no result, where PyTorch sees fewer CUDA devices than the cell
asks for, where the program (`src/repro_torch`) is not in the checkout,
or where JAX or the JAX package was loaded in this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")


def fail(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"the program is not in {ROOT}/src/repro_torch")
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

    import torch
    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.entry["chips"]:
        fail(f"{args.workload} needs {cell.entry['chips']} CUDA device(s); "
             f"PyTorch sees {torch.cuda.device_count()}")
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = harness.loaded_forbidden()
    if found:
        fail(f"loaded in this process: {', '.join(found)}")
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
