"""moe_device_pct.decode: the share of the second traced slice's kernel
device seconds whose launches fell inside the program's `ffn.moe` spans
(the MoE ffn: its norm, routing, dispatch, expert products, combine and
shared expert), in %, from `spans.py`'s attribution. Nothing where the
program recorded no `lm.decode` span."""
from portbench import spans


def read(ctx):
    return spans.device_share(spans.reading(ctx), "ffn.moe", "lm.decode")
