"""The port's partition rules (repro_torch.sharding.partition) against the
reference's (repro.sharding.partition), spec by spec: params, AdamW and
Adafactor state, the input batches of every shape kind, and the decode
caches (B = 128, and B = 1 with `seq_shard_decode`), for all ten full
configs on the production mesh shapes 16x16 and 2x16x16. Both packages'
rules read a mesh's axis names and sizes only, so both take the same
duck-typed mesh and no devices (the reference's 512-device XLA flag is
not needed). Then the activation-sharding context
(repro_torch.sharding.context): `constrain` and `constrain_batch_tree`
are the identity without a mapping, and DTensor placements of the specs
on a fake 16x16 mesh.
"""
import dataclasses
import functools
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import PartitionSpec as P

from repro.models import inputs as jinputs
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.models.config import SHAPES
from repro.sharding import partition as jpart
from repro_torch.models import inputs as tinputs
from repro_torch.models import lm
from repro_torch.models import registry
from repro_torch.sharding import context, partition
from torch.utils import _pytree as pytree

ALL_ARCHS = sorted(registry.ARCHS)
MESHES = {
    "pod16x16": SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": 16, "model": 16}),
    "pod2x16x16": SimpleNamespace(axis_names=("pod", "data", "model"),
                                  shape={"pod": 2, "data": 16,
                                         "model": 16}),
}


def _ref_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {jpart._path_str(p): tuple(s) for p, s in flat}


def _port_specs(tree) -> dict:
    flat, _ = pytree.tree_flatten_with_path(tree, is_leaf=partition._is_spec)
    return {partition._path_str(p): s for p, s in flat}


@functools.lru_cache(maxsize=None)
def _abstract(arch: str, optimizer: str | None = None):
    """(reference cfg, port cfg, reference params, port params), the
    configs with `optimizer` in place of their own where given."""
    jcfg, tcfg = jreg.get_config(arch), registry.get_config(arch)
    if optimizer is not None:
        jcfg = dataclasses.replace(jcfg, optimizer=optimizer)
        tcfg = dataclasses.replace(tcfg, optimizer=optimizer)
    return jcfg, tcfg, jlm.init_abstract(jcfg), lm.init_abstract(tcfg)


def _same(got: dict, want: dict):
    # the same leaves (torch's pytree keeps a dict's insertion order,
    # JAX sorts its keys) under the same specs
    assert sorted(got) == sorted(want)
    apart = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not apart


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_reference(arch, mesh):
    jcfg, tcfg, jp, tp = _abstract(arch)
    m = MESHES[mesh]
    got = _port_specs(partition.param_specs(tcfg, tp, m))
    _same(got, _ref_specs(jpart.param_specs(jcfg, jp, m)))
    assert any(any(a is not None for a in s) for s in got.values())


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_opt_specs_match_reference(arch, mesh, optimizer):
    jcfg, tcfg, jp, tp = _abstract(arch, optimizer)
    m = MESHES[mesh]
    jinit, _ = jlm.make_optimizer(jcfg)
    tinit, _ = lm.make_optimizer(tcfg)
    want = jpart.opt_specs(jpart.param_specs(jcfg, jp, m), jp,
                           jax.eval_shape(jinit, jp))
    got = partition.opt_specs(partition.param_specs(tcfg, tp, m), tp,
                              tinit(tp))
    _same(_port_specs(got), _ref_specs(want))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_specs_match_reference(arch, mesh, shape):
    jcfg, tcfg, _, _ = _abstract(arch)
    m = MESHES[mesh]
    got = partition.batch_specs(tinputs.input_specs(tcfg, SHAPES[shape]), m)
    want = jpart.batch_specs(jinputs.input_specs(jcfg, SHAPES[shape]), m)
    _same(_port_specs(got), _ref_specs(want))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_match_reference(arch, mesh, shape):
    """B = 128 (batch over dp) and B = 1 (the cache length over dp, the
    reference's sequence parallelism; every full config sets
    `seq_shard_decode`)."""
    jcfg, tcfg, _, _ = _abstract(arch)
    m = MESHES[mesh]
    s = SHAPES[shape]
    assert tcfg.seq_shard_decode
    got = partition.cache_specs(
        tcfg, lm.cache_abstract(tcfg, s.global_batch, s.seq_len), m,
        batch_size=s.global_batch)
    want = jpart.cache_specs(
        jcfg, jlm.cache_abstract(jcfg, s.global_batch, s.seq_len), m,
        batch_size=s.global_batch)
    _same(_port_specs(got), _ref_specs(want))


def test_choose_spec_falls_back_as_the_reference():
    """yi-34b's 56 heads take head-dim sharding on 16-way tp; a shape no
    candidate divides is replicated."""
    m = MESHES["pod16x16"]
    cands = [("data", "model", None), ("data", None, "model")]
    assert partition.choose_spec((7168, 56, 128), cands, m) == \
        ("data", None, "model")
    assert partition.choose_spec((7, 5), [("data",)], m) == (None, None)
    assert partition.mesh_dp_axes(MESHES["pod2x16x16"]) == ("pod", "data")
    assert partition.axis_size(MESHES["pod2x16x16"], ("pod", "data")) == 32


def test_constrain_is_the_identity_without_a_mapping():
    x = torch.randn(4, 8, 16)
    tree = {"tokens": torch.zeros(2, 4, 8, dtype=torch.int64), "x": [x]}
    assert context.constrain(x, "act_btd") is x
    assert context.constrain_batch_tree(tree, leading=1) is tree
    assert context.dp_axes() is None
    # under a mapping, a plain tensor (no DTensor) is still left as it is
    mapping = {"dp": "data", "axis_sizes": {"data": 2, "model": 1},
               "act_btd": ("data", None, None)}
    with context.activation_sharding(mapping):
        assert context.constrain(x, "act_btd") is x
        out = context.constrain_batch_tree(tree, leading=1)
        assert out["x"][0] is x and out["tokens"] is tree["tokens"]
        assert context.dp_axes() == "data"
    assert context.dp_axes() is None


def _run(code: str) -> str:
    """Runs `code` in a fresh interpreter (its fake process group never
    meets this one's) and returns its output."""
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600,
                       env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
                            "HOME": "/tmp"})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


def test_placements_and_meta_dtensors_on_a_fake_production_mesh():
    """On a DeviceMesh of a fake 256-rank group: the rules give the same
    specs as through the duck-typed mesh, `to_placements` shards each
    dim over its axes, and `abstract_with_sharding` gives meta DTensors
    whose local shards are the spec's split, with no collective."""
    out = _run("""
        import torch
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.debug import CommDebugMode
        from repro_torch.launch.mesh import fake_world, \\
            make_production_mesh
        from repro_torch.models import lm, registry
        from repro_torch.sharding import partition
        cfg = registry.get_config("yi-9b")
        p = lm.init_abstract(cfg)
        with fake_world(512):
            mesh = make_production_mesh(multi_pod=True)
            specs = partition.param_specs(cfg, p, mesh)
            duck = partition.mesh_axes(mesh)
            assert duck.shape == {"pod": 2, "data": 16, "model": 16}
            assert specs == partition.param_specs(cfg, p, duck)
            pl = partition.to_placements((("pod", "data"), "model"), mesh)
            assert pl == [Shard(0), Shard(0), Shard(1)], pl
            assert partition.to_placements((None,), mesh) == \\
                [Replicate()] * 3
            with CommDebugMode() as comm:
                d = partition.abstract_with_sharding(p, specs, mesh)
            assert comm.get_total_counts() == 0
            wq = d["stacks"][0][0]["mixer"]["wq"]
            assert tuple(wq.shape) == tuple(p["stacks"][0][0]["mixer"]["wq"]
                                            .shape)
            assert wq.to_local().device.type == "meta"
            # [48, 4096, 32, 128]: D over (pod, data), heads over model
            assert tuple(wq.to_local().shape) == (48, 128, 2, 128)
            assert partition.spec_bytes(p, specs, mesh) * 512 >= \\
                lm.param_count(p) * 2
        import torch.distributed as dist
        assert not dist.is_initialized()
        print("PLACEMENTS OK")
    """)
    assert "PLACEMENTS OK" in out
