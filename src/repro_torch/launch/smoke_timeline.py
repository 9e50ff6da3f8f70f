"""`chip_smoke.py` with every line it logs stamped by the seconds since its
start, then the lines that took longest after the one before them: where
the script's time goes, phase by phase and step by step.

    PYTHONPATH=src python -m repro_torch.launch.smoke_timeline [--gaps 40]

Run it from the root of a checkout (the directory that holds
`chip_smoke.py`). It exits with the script's own code.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
STAMP = re.compile(r"\s*(\d+\.\d+) (.*)")


def largest_gaps(lines: list[str], n: int) -> list[tuple[float, float, str]]:
    """(seconds since the stamped line before, stamp, text) of the `n`
    stamped lines that came longest after their predecessor, longest
    first. Unstamped lines are skipped."""
    out, prev = [], 0.0
    for line in lines:
        m = STAMP.match(line)
        if m:
            t = float(m.group(1))
            out.append((t - prev, t, m.group(2)))
            prev = t
    return sorted(out, reverse=True)[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gaps", type=int, default=40,
                    help="how many of the longest gaps to list at the end")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke
    t0 = time.perf_counter()
    lines = []
    log = chip_smoke.log

    def stamped(*parts) -> None:
        line = " ".join(str(p) for p in parts)
        line = f"{time.perf_counter() - t0:8.1f} {line}"
        lines.append(line)
        log(line)
    chip_smoke.log = stamped
    try:
        rc = chip_smoke.main()
    finally:
        chip_smoke.log = log
    if lines:
        print(f"[timeline] the {args.gaps} lines that took longest:",
              flush=True)
    for gap, t, text in largest_gaps(lines, args.gaps):
        print(f"[timeline] {gap:7.1f} s before {t:7.1f}: {text[:150]}",
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
