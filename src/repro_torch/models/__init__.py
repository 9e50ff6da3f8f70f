"""Model zoo: the 10 assigned architectures as selectable configs.

The port's counterpart of `repro.models`: the same exports. `layers`,
`lm`, `inputs` and `params` hold every mixer and ffn of the ten archs,
their forward, train step and prefill/decode serve path, and the
abstract (meta-device) params, caches and input specs.
"""
from repro_torch.models.config import ModelConfig, SHAPES, ShapeSpec, \
    Stack, shape_applicable
from repro_torch.models.registry import ARCHS, get_config, \
    get_smoke_config, list_archs

__all__ = [
    "ModelConfig", "SHAPES", "ShapeSpec", "Stack", "shape_applicable",
    "ARCHS", "get_config", "get_smoke_config", "list_archs",
]
