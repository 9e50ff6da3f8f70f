"""moe_weight_use_pct.decode: the program's counter `moe.experts_hit`
(experts with at least one kept (token, choice) pair) over
`moe.experts_read` (experts whose weights the expert products read), summed
over the MoE layers and steps of the second traced slice, in %. Nothing
where the program counted no expert read or ran no `lm.decode` span."""
from portbench import spans


def read(ctx):
    r = spans.reading(ctx)
    if r is None or "lm.decode" not in r["roots"]:
        return None
    c = ctx["counters"]
    if not c.get("moe.experts_read"):
        return None
    return 100.0 * c.get("moe.experts_hit", 0) / c["moe.experts_read"]
