"""Readings for the limits that decide `correct`: the program's and the
control's, seed by seed, in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed: the cell's weights and driver as a run makes them, a
window of `--seconds` at the cell's own load (a decode cell then runs its
first batch to its end), and the comparison of the same outputs as a run
makes it, for the program and for the control, the reference computed in
fp8 and put in the program's place (`reference/_plain.py`), each judged
by the harness's own `verdict` against the cell's limits
(`workloads/<cell>.json`). Prints one JSON line a seed, with
`program_correct` and `control_correct`. The benchmark's runs do not run the control; this tool
gives the readings from which `workloads/<cell>.json`'s limits were set
(lower: the largest of the program's over a dozen seeds or more; upper:
the smallest of the control's). Needs the card, as `run.py` does.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root: str, name: str, seed: int, seconds: float,
             device) -> dict:
    """The program's and the control's readings of one seed."""
    import torch
    from portbench import harness
    from portbench.compare import verdict

    t0 = time.perf_counter()
    cell, drv = harness.build(root, name, seed, device)
    setup_s = time.perf_counter() - t0
    win = drv.window(seconds)
    drv.release()
    t1 = time.perf_counter()
    program, control = drv.check(
        harness.load_module(cell.reference_path, "portbench_reference"),
        cell.config, control=True)
    out = {"seed": seed, "program": program, "control": control,
           "program_correct": verdict(program, cell.limits),
           "control_correct": verdict(control, cell.limits),
           "setup_s": setup_s, "per_call_s": win["per_call_s"],
           "check_s": time.perf_counter() - t1}
    del drv
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="program and control "
                                             "readings, seed by seed")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        sys.exit(2)
    for seed in args.seeds:
        print(json.dumps(readings(ROOT, args.workload, seed, args.seconds,
                                  "cuda")), flush=True)


if __name__ == "__main__":
    main()
