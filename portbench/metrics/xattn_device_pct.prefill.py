"""xattn_device_pct.prefill: the share of the second traced slice's kernel
device seconds whose launches fell inside the program's `mixer.xattn`
spans (a block's cross-attention to the text states: its norm, query and
output projections, the attention and, at prefill, the keys and values
of its cross cache), in %, from `spans.py`'s attribution. Nothing where
the program recorded no `lm.prefill` span."""
from portbench import spans


def read(ctx):
    return spans.device_share(spans.reading(ctx), "mixer.xattn",
                              "lm.prefill")
