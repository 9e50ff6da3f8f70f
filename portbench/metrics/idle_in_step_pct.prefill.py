"""idle_in_step_pct.prefill: the device's idle time while an `lm.prefill`
span was open on the host, over the second traced slice's wall time, in %
(the base of `device_idle_pct.prefill`: the rest of the slice's idle is
outside the program). From `spans.py`; nothing where the program recorded
no `lm.prefill` span."""
from portbench import spans


def read(ctx):
    return spans.idle_in_step(spans.reading(ctx), "lm.prefill")
