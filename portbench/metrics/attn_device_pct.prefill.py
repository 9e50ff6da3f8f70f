"""attn_device_pct.prefill: the share of the second traced slice's kernel
device seconds whose launches fell inside the program's `attn.core` spans
(`chunked_attention`, `cache_attention`, MLA decode's scores and
context), in %, from `spans.py`'s attribution. Nothing where the program
recorded no `lm.prefill` span."""
from portbench import spans


def read(ctx):
    return spans.device_share(spans.reading(ctx), "attn.core", "lm.prefill")
