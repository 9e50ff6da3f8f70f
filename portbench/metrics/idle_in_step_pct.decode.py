"""idle_in_step_pct.decode: the device's idle time while an `lm.decode`
span was open on the host, over the second traced slice's wall time, in %
(the base of `device_idle_pct.decode`: the rest of the slice's idle is
outside the program, in the driver's argmax and token copy). From
`spans.py`; nothing where the program recorded no `lm.decode` span."""
from portbench import spans


def read(ctx):
    return spans.idle_in_step(spans.reading(ctx), "lm.decode")
