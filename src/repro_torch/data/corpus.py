"""Corpus assembly: structural kernel hashing and train/val/test splits.

Two split strategies (paper §4):
  * random — programs partitioned randomly,
  * manual — whole program *families* held out of training, chosen for
    subjective dissimilarity (here: convdraw + embedding, the analogues of
    the paper's hardest holdouts).
"""
from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.core.graph import KernelGraph

MANUAL_TEST_FAMILIES = ("convdraw", "embedding")
MANUAL_VAL_FAMILIES = ("norm",)


def kernel_hash(g: KernelGraph) -> str:
    h = hashlib.sha1()
    for n in g.nodes:
        h.update(n.op.name.encode())
        h.update(repr((n.shape, n.dtype_bytes, n.inputs, n.is_output,
                       n.contract_dim, n.filter_size,
                       n.reduced_dims)).encode())
    h.update(repr(g.tile_size).encode())
    return h.hexdigest()


def family_of(program_name: str) -> str:
    return program_name.rsplit("_", 1)[0]


def split_programs(program_names: list[str], *, method: str = "random",
                   seed: int = 0, val_frac: float = 0.1,
                   test_frac: float = 0.1) -> dict[str, list[str]]:
    """Returns {'train': [...], 'val': [...], 'test': [...]} program names."""
    names = sorted(set(program_names))
    if method == "random":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(names))
        n_test = max(1, int(round(test_frac * len(names))))
        n_val = max(1, int(round(val_frac * len(names))))
        test = [names[i] for i in perm[:n_test]]
        val = [names[i] for i in perm[n_test:n_test + n_val]]
        train = [names[i] for i in perm[n_test + n_val:]]
        return {"train": sorted(train), "val": sorted(val),
                "test": sorted(test)}
    if method == "manual":
        test = [n for n in names if family_of(n) in MANUAL_TEST_FAMILIES]
        val = [n for n in names if family_of(n) in MANUAL_VAL_FAMILIES]
        train = [n for n in names
                 if n not in set(test) and n not in set(val)]
        return {"train": train, "val": val, "test": test}
    raise ValueError(f"unknown split method {method!r}")


def filter_by_programs(records, names: list[str]):
    name_set = set(names)
    return [r for r in records if r.program in name_set]
