"""xattn_device_pct.decode: the share of the second traced slice's kernel
device seconds whose launches fell inside the program's `mixer.xattn`
spans (a block's cross-attention to the text states over the cross cache
that prefill built: its norm, query and output projections and the
attention), in %, from `spans.py`'s attribution. Nothing where the
program recorded no `lm.decode` span."""
from portbench import spans


def read(ctx):
    return spans.device_share(spans.reading(ctx), "mixer.xattn",
                              "lm.decode")
