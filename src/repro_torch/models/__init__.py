"""Model zoo: the 10 assigned architectures as selectable configs.

The port's counterpart of `repro.models`: the same exports. `layers`,
`lm`, `inputs` and `params` hold the dense-attention forward and the
prefill/decode serve path (the other mixers wait for later slices).
"""
from repro_torch.models.config import ModelConfig, SHAPES, ShapeSpec, \
    Stack, shape_applicable
from repro_torch.models.registry import ARCHS, get_config, \
    get_smoke_config, list_archs

__all__ = [
    "ModelConfig", "SHAPES", "ShapeSpec", "Stack", "shape_applicable",
    "ARCHS", "get_config", "get_smoke_config", "list_archs",
]
