"""host_step_ms.decode: the median host duration of the program's
`lm.decode` spans in the third traced slice (recording on, no profiler),
in ms: the time the host takes to enqueue one decode step. From
`spans.py`; nothing where the program recorded no `lm.decode` span."""
import statistics

from portbench import spans


def read(ctx):
    r = spans.reading(ctx)
    if r is None or "lm.decode" not in r["plain"]["roots"]:
        return None
    return statistics.median(r["plain"]["roots"]["lm.decode"]) * 1e3
