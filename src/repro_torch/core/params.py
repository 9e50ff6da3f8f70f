"""Carrying weights across from the JAX package.

* `from_jax_params(tree, cfg)` — a JAX cost-model parameter tree given as
  nested dicts/lists of numpy arrays, in either GNN layout (unrolled
  `gnn/layers/<i>/...` or stacked `gnn/stacked/...`), → a loaded
  `CostModel` in the layout `cfg.scan_layers` asks for.
* `read_jax_checkpoint(ckpt_dir)` — a jax-free reader of the JAX
  checkpoint directory format (`step_<8 digits>/manifest.json` plus one
  `.npy` file per leaf, keys are '/'-joined tree paths), returning the
  saved tree as nested dicts/lists of numpy arrays.
* `load_jax_checkpoint(ckpt_dir, cfg)` — both together: a model trained
  by the JAX trainer (state `{"params": ..., "opt": ...}`) serves here.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core import gnn as G
from repro_torch.core.device import resolve_device
from repro_torch.core.model import CostModel, CostModelConfig, \
    cost_model_init

_MANIFEST = "manifest.json"
_PREFIX = "step_"


def _to_tensors(tree):
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _shapes(tree, prefix=""):
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
    return CostModel(params, cfg).to(dev)


def _unflatten(flat: dict):
    """{'a/0/w': arr, ...} → nested dicts, with all-digit keys as lists."""
    root: dict = {}
    for key, arr in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(root)


def _steps(ckpt_dir: str) -> list[int]:
    """Complete checkpoint steps in `ckpt_dir` (those with a manifest)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n[len(_PREFIX):]) for n in os.listdir(ckpt_dir)
                  if n.startswith(_PREFIX) and os.path.exists(
                      os.path.join(ckpt_dir, n, _MANIFEST)))


def read_jax_checkpoint(ckpt_dir: str, *, step: int | None = None
                        ) -> tuple[dict, int, dict]:
    """Read a JAX checkpoint without jax. Returns (tree of numpy arrays,
    step, meta); `step` defaults to the latest."""
    if step is None:
        steps = _steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        step = steps[-1]
    path = os.path.join(ckpt_dir, f"{_PREFIX}{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    flat = {}
    for e in manifest["leaves"]:
        arr = np.load(os.path.join(path, e["file"]), allow_pickle=False)
        if list(arr.shape) != list(e["shape"]):
            raise ValueError(f"leaf {e['key']!r}: file shape {arr.shape} "
                             f"!= manifest shape {e['shape']}")
        flat[e["key"]] = arr
    return _unflatten(flat), int(manifest["step"]), manifest.get("meta", {})


def load_jax_checkpoint(ckpt_dir: str, cfg: CostModelConfig, *,
                        step: int | None = None,
                        device: str | torch.device = "cuda") -> CostModel:
    """The cost model saved in a JAX checkpoint: the `params` entry of a
    trainer state, or the whole tree if it is a bare parameter tree."""
    tree, _, _ = read_jax_checkpoint(ckpt_dir, step=step)
    return from_jax_params(tree.get("params", tree), cfg, device=device)
