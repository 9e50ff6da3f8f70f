"""Int8 quantized inference for the cost model (counterpart of
`repro.quant`).

* `repro_torch.quant.scale` — the symmetric-int8 primitives
  (scale/clip/round + `QuantizedLeaf`);
* `repro_torch.quant.quantize` — per-channel weight quantization of a
  cost model (`quantize_params` → `QuantizedCostModel`), activation
  calibration, and the checkpoint sidecar (`save_quantized` /
  `load_quantized`).

Exports resolve lazily (PEP 562): `core.model` imports `quant.scale`,
and `quant.quantize` imports `core.model`, so this package must not
import `quantize` eagerly.
"""
import importlib

_EXPORTS = {
    "INT8_MAX": "scale",
    "QuantizedLeaf": "scale",
    "amax_scale": "scale",
    "dequantize_int8": "scale",
    "dequantize_tree": "scale",
    "leaf_f32": "scale",
    "per_channel_scale": "scale",
    "quantize_int8": "scale",
    "tree_is_quantized": "scale",
    "QuantizedCostModel": "quantize",
    "calibrate_activations": "quantize",
    "dequantize_params": "quantize",
    "load_quantized": "quantize",
    "quantize_params": "quantize",
    "save_quantized": "quantize",
    "tree_bytes": "quantize",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.quant' has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
