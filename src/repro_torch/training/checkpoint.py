"""Atomic, manifest-driven checkpoints in the JAX package's format.

Counterpart of `repro.training.checkpoint`; the files are the same, so a
checkpoint written by either package restores in the other:

* Every leaf of the state tree (nested dicts/lists of tensors or numpy
  arrays) is saved as its own `leaf_<5 digits>.npy`, numbered in JAX's
  flatten order (dict keys sorted, list items in order), plus a
  `manifest.json` holding `step`, `meta` and for each leaf its key (the
  '/'-joined tree path), file, shape and dtype.
* Atomicity: everything is written into `<dir>/.tmp-<step>` and renamed
  to `<dir>/step_<8 digits>` in one `os.replace`, so a killed writer never
  corrupts an existing checkpoint; directories without a manifest are
  ignored, and only the newest `keep` complete ones are kept.
* Restore reads the leaves host-side as numpy and places each on the
  device of the template's leaf; the GNN's unrolled (`.../layers/<i>/...`)
  and stacked (`.../stacked/...`) layouts convert both ways.

`read_checkpoint` reads a checkpoint without a template, as nested
dicts/lists of numpy arrays.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

_MANIFEST = "manifest.json"
_PREFIX = "step_"

_LAYER_RE = re.compile(r"/layers/(\d+)/")


def _resolve_leaf(key: str, want_shape: tuple, by_key: dict, path: str):
    """Load the checkpoint leaf for template key `key`, converting between
    the unrolled (`.../layers/<i>/...`) and stacked (`.../stacked/...`) GNN
    layouts when the on-disk layout differs from the template's
    (`core.gnn.stack_params`). Bit-exact both ways: stacking is `np.stack`
    of the per-layer arrays, unstacking is a slice.

    Returns the numpy array, or None if the key can't be resolved.
    """
    if key in by_key:
        return np.load(os.path.join(path, by_key[key]["file"]))
    if "/stacked/" in key and len(want_shape) >= 1:
        # template wants stacked [L, ...]; try per-layer on-disk leaves
        num = want_shape[0]
        parts = []
        for i in range(num):
            k = key.replace("/stacked/", f"/layers/{i}/")
            if k not in by_key:
                return None
            parts.append(np.load(os.path.join(path, by_key[k]["file"])))
        return np.stack(parts, axis=0)
    m = _LAYER_RE.search(key)
    if m is not None:
        # template wants layer i unrolled; try the stacked on-disk leaf
        k = key[:m.start()] + "/stacked/" + key[m.end():]
        if k in by_key:
            stacked = np.load(os.path.join(path, by_key[k]["file"]))
            i = int(m.group(1))
            if i < stacked.shape[0]:
                return stacked[i]
    return None


def _leaf_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(key, leaf) pairs in JAX's flatten order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaf_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _rebuild(tree, it):
    """`tree`'s structure with its leaves taken in turn from `it`."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{_PREFIX}{step:08d}")


def save_checkpoint(ckpt_dir: str, step: int, state, *,
                    meta: dict | None = None, keep: int = 3) -> str:
    """Save `state` (nested dicts/lists of tensors or arrays) for `step`.
    Returns the final path."""
    final = _step_dir(ckpt_dir, step)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": int(step), "meta": meta or {}, "leaves": []}
    for i, (key, leaf) in enumerate(_leaf_paths(state)):
        arr = _numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "key": key, "file": fname,
            "shape": list(arr.shape), "dtype": str(arr.dtype),
        })
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)

    # retention
    for s in list_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
    return final


def list_steps(ckpt_dir: str) -> list[int]:
    """Steps of the complete checkpoints in `ckpt_dir` (those with a
    manifest), ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n[len(_PREFIX):]) for n in os.listdir(ckpt_dir)
                  if n.startswith(_PREFIX) and os.path.exists(
                      os.path.join(ckpt_dir, n, _MANIFEST)))


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _manifest(ckpt_dir: str, step: int | None) -> tuple[str, dict]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, _MANIFEST)) as f:
        return path, json.load(f)


def restore_checkpoint(ckpt_dir: str, like, *, step: int | None = None):
    """Restore into the structure of `like` (a template tree of tensors):
    each leaf keeps the checkpoint's dtype and goes to the device of the
    template's leaf. `step` defaults to the latest. Raises KeyError for
    a leaf the checkpoint lacks and ValueError for one of another shape.
    Returns (state, step, meta)."""
    path, manifest = _manifest(ckpt_dir, step)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    new_leaves = []
    for key, leaf in _leaf_paths(like):
        want_shape = tuple(leaf.shape)
        arr = _resolve_leaf(key, want_shape, by_key, path)
        if arr is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"leaf {key!r}: checkpoint shape {arr.shape} != {want_shape}")
        new_leaves.append(torch.from_numpy(arr).to(leaf.device))
    state = _rebuild(like, iter(new_leaves))
    return state, int(manifest["step"]), manifest.get("meta", {})


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


def read_checkpoint(ckpt_dir: str, *, step: int | None = None
                    ) -> tuple[dict, int, dict]:
    """Read a checkpoint without a template. Returns (tree of numpy
    arrays, step, meta); `step` defaults to the latest."""
    path, manifest = _manifest(ckpt_dir, step)
    flat = {}
    for e in manifest["leaves"]:
        arr = np.load(os.path.join(path, e["file"]), allow_pickle=False)
        if list(arr.shape) != list(e["shape"]):
            raise ValueError(f"leaf {e['key']!r}: file shape {arr.shape} "
                             f"!= manifest shape {e['shape']}")
        flat[e["key"]] = arr
    return _unflatten(flat), int(manifest["step"]), manifest.get("meta", {})
