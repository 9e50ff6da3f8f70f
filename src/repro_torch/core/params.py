"""Carrying weights across from the JAX package.

* `from_jax_params(tree, cfg)` — a JAX cost-model parameter tree given as
  nested dicts/lists of numpy arrays, in either GNN layout (unrolled
  `gnn/layers/<i>/...` or stacked `gnn/stacked/...`), → a loaded
  `CostModel` in the layout `cfg.scan_layers` asks for.
* `read_jax_checkpoint(ckpt_dir)` — `training.checkpoint.read_checkpoint`,
  the reader of the checkpoint format both packages write
  (`step_<8 digits>/manifest.json` plus one `.npy` file per leaf, keys
  are '/'-joined tree paths), returning the saved tree as nested
  dicts/lists of numpy arrays.
* `load_jax_checkpoint(ckpt_dir, cfg)` — both together: a model trained
  by the JAX trainer (state `{"params": ..., "opt": ...}`) serves here.
* `from_jax_quantized(tree, act_scales, config)` — a JAX
  `QuantizedCostModel`'s parts, its tree as numpy with each
  `QuantizedLeaf` as an object holding numpy `q` and `scale` (what
  `jax.tree_util.tree_map(np.asarray, qm.params)` gives), → the port's
  `QuantizedCostModel`, bit-exact. (The sidecar is the other route:
  `quant.quantize.load_quantized` reads one written by either package.)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import gnn as G
from repro_torch.core.device import resolve_device
from repro_torch.core.model import CostModel, CostModelConfig, \
    cost_model_init
from repro_torch.quant.quantize import QuantizedCostModel
from repro_torch.quant.scale import QuantizedLeaf
from repro_torch.training.checkpoint import \
    read_checkpoint as read_jax_checkpoint


def _to_tensors(tree):
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _shapes(tree, prefix=""):
    if isinstance(tree, QuantizedLeaf):
        return {prefix[:-1]: tuple(tree.q.shape)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


def _check_shapes(params: dict, cfg: CostModelConfig) -> None:
    """Raise ValueError unless `params` has the keys and shapes of a
    `cfg` model (a quantized leaf counts by its `q`)."""
    # the expected keys and shapes, from a throwaway CPU init of `cfg`
    want = _shapes(cost_model_init(torch.Generator(), cfg,
                                   device="cpu").tree())
    got = _shapes(params)
    if want != got:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(f"parameter tree does not match the config: "
                         f"missing {missing}, unexpected {extra}, "
                         f"wrong shape {wrong}")


def from_jax_params(tree: dict, cfg: CostModelConfig, *,
                    device: str | torch.device = "cuda") -> CostModel:
    """Load a JAX parameter tree (numpy leaves) into a `CostModel` on
    `device`. Raises ValueError if the tree does not match `cfg`."""
    dev = resolve_device(device)
    params = _to_tensors(tree)
    if "gnn" in params:
        gnn = G.unstack_params(params["gnn"])
        # as cost_model_init: an empty layer list stays unrolled
        params["gnn"] = (G.stack_params(gnn)
                         if cfg.scan_layers and gnn["layers"] else gnn)
    _check_shapes(params, cfg)
    return CostModel(params, cfg).to(dev)


def _quantized_to_tensors(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _quantized_to_tensors(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_quantized_to_tensors(v, dev) for v in tree]
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QuantizedLeaf(torch.from_numpy(np.array(tree.q)).to(dev),
                             torch.from_numpy(np.array(tree.scale)).to(dev))
    return torch.from_numpy(np.array(tree)).to(dev)


def from_jax_quantized(tree: dict, act_scales: dict | None = None,
                       config: dict | None = None, *,
                       device: str | torch.device = "cuda"
                       ) -> QuantizedCostModel:
    """The port's `QuantizedCostModel` from a JAX one's `params` (numpy
    leaves; each quantized leaf any object with numpy `q` and `scale`),
    `act_scales` and `config`, on `device`. Values are copied bit for
    bit and the GNN layout is kept (the config names it). Raises
    ValueError if the tree does not match the config."""
    dev = resolve_device(device)
    qm = QuantizedCostModel(_quantized_to_tensors(tree, dev),
                            act_scales=dict(act_scales or {}),
                            config=config)
    if config is not None:
        _check_shapes(qm.params, qm.serving_config())
    return qm


def load_jax_checkpoint(ckpt_dir: str, cfg: CostModelConfig, *,
                        step: int | None = None,
                        device: str | torch.device = "cuda") -> CostModel:
    """The cost model saved in a checkpoint of either package's trainer:
    the `params` entry of a trainer state, or the whole tree if it is a
    bare parameter tree."""
    tree, _, _ = read_jax_checkpoint(ckpt_dir, step=step)
    return from_jax_params(tree.get("params", tree), cfg, device=device)
