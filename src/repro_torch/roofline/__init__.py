"""Roofline terms from the port's dry-run records (`analysis`) and the
probe lowering that extrapolates them (`probes`): `repro.roofline`."""
from repro_torch.roofline.analysis import (
    H100_HW,
    ROOFLINE_HW,
    active_param_count,
    build_table,
    model_flops,
    render_markdown,
    roofline_terms,
)

__all__ = ["H100_HW", "ROOFLINE_HW", "active_param_count", "build_table",
           "model_flops", "render_markdown", "roofline_terms"]
