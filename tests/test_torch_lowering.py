"""The port's lowering (repro_torch.launch.lowering): twins of
tests/test_distributed.py's `test_smoke_archs_lower_on_mesh` (every smoke
arch × {train, prefill, decode, long decode} lowers on a 4x2 mesh with the
production partition rules: 40 cells, each with flops > 0) and
`test_multipod_mesh_smoke` (a (pod, data, model) 2x2x2 mesh lowers a
train step whose gradient reduction moves bytes). The meshes are fake
process groups, each in a subprocess of its own; one arch's four cells
share one.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, timeout: int = 900) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


MOE_FALLBACKS = {"aten.bincount.default (no sharding rule)",
                 "aten.index_put_.default (writes a plain tensor)"}
TRAIN_FALLBACKS = {"aten.view.default (uneven unflatten)",
                   "aten._unsafe_view.default (uneven unflatten)"}


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_smoke_arch_lowers_on_a_4x2_mesh(arch):
    """The four cells of one arch: train (8 x 64, microbatch 2), prefill
    and decode (8 x 64), long decode (1 x 64, the cache length over dp)."""
    out = _run(f"""
        import json
        from repro_torch.launch.lowering import lower_cell
        from repro_torch.launch.mesh import fake_world, make_mesh
        from repro_torch.models import registry
        from repro_torch.models.config import ShapeSpec
        shapes = [ShapeSpec("t", 64, 8, "train"),
                  ShapeSpec("p", 64, 8, "prefill"),
                  ShapeSpec("d", 64, 8, "decode"),
                  ShapeSpec("l", 64, 1, "decode")]
        cells = []
        with fake_world(8):
            mesh = make_mesh((4, 2), ("data", "model"))
            cfg = registry.get_smoke_config({arch!r})
            for shape in shapes:
                cell = lower_cell({arch!r}, cfg, shape, mesh, "test")
                mem = vars(cell.memory_analysis)
                cells.append([shape.kind, cell.cost_analysis["flops"],
                              cell.collective_bytes, mem,
                              cell.params_bytes, cell.fallbacks,
                              cell.fallback_collectives])
        print(json.dumps(cells))
    """)
    cells = json.loads(out.strip().splitlines()[-1])
    assert len(cells) == 4
    moe = registry.get_smoke_config(arch).moe is not None
    for kind, flops, coll, mem, params_bytes, fallbacks, fb_coll in cells:
        assert flops > 0, kind
        # the ops run replicated are the known ones: the MoE's dispatch
        # (no sharding rule for its bincount, its index_put_ into fresh
        # buffers) and, in train cells, the unflattens of the smoke
        # microbatch of 2 over a dp of 4
        allowed = (MOE_FALLBACKS if moe else set()) | (
            TRAIN_FALLBACKS if kind == "train" else set())
        assert set(fallbacks) <= allowed, (kind, fallbacks)
        if moe:
            assert MOE_FALLBACKS <= set(fallbacks), (kind, fallbacks)
        # what they move is a part of the collectives, and the lesser one
        for k, v in fb_coll.items():
            assert v <= coll[k], (kind, k)
        total = sum(v for k, v in coll.items() if k != "_counts")
        assert sum(fb_coll.values()) < 0.5 * total, kind
        if not fallbacks:
            assert fb_coll == {}
        assert mem["argument_size_in_bytes"] > 0
        # the peak estimate holds the arguments and what the step makes
        assert mem["peak_memory_in_bytes"] > mem["argument_size_in_bytes"]
        assert mem["temp_size_in_bytes"] == \
            mem["peak_memory_in_bytes"] - mem["argument_size_in_bytes"]
        assert 0 < params_bytes
        # one device holds a part of the arguments: 8 ranks share them
        assert mem["argument_size_in_bytes"] < params_bytes * (
            3 if kind == "train" else 2)
        if kind == "train":
            # the donated params and optimizer state alias the outputs
            assert 0 < mem["alias_size_in_bytes"] <= \
                mem["argument_size_in_bytes"]
            assert sum(v for k, v in coll.items() if k != "_counts") > 0
        if kind == "prefill":
            assert mem["alias_size_in_bytes"] == 0


def test_multipod_mesh_lowers_a_train_step():
    """(pod, data, model) = 2x2x2: the pod axis shards the batch with
    data, so the gradient reduction crosses pods."""
    out = _run("""
        import json
        from repro_torch.launch.lowering import lower_cell
        from repro_torch.launch.mesh import activation_mapping, \\
            fake_world, make_mesh
        from repro_torch.models import registry
        from repro_torch.models.config import ShapeSpec
        with fake_world(8):
            mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
            assert activation_mapping(mesh)["dp"] == ("pod", "data")
            cfg = registry.get_smoke_config("yi-9b")
            cell = lower_cell("yi-9b", cfg, ShapeSpec("t", 64, 8, "train"),
                              mesh, "multipod")
        coll = {k: v for k, v in cell.collective_bytes.items()
                if k != "_counts"}
        print(json.dumps([cell.cost_analysis["flops"], coll]))
    """)
    flops, coll = json.loads(out.strip().splitlines()[-1])
    assert flops > 0
    assert sum(coll.values()) > 0
    assert coll.get("all-reduce", 0) + coll.get("reduce-scatter", 0) > 0


def test_counter_runs_views_and_pads_on_the_local_shard():
    """Views DTensor's rules refuse or get wrong run on the local shard
    with no collective and no fallback: an unflatten of a dim that both
    mesh dims shard, the flatten back, a flatten whose sharded dims are
    not its leading ones (relabeled: the same local sizes), and a pad of
    an unsharded dim."""
    out = _run("""
        import json, torch
        import torch.nn.functional as F
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch.mesh import fake_world, make_mesh
        from repro_torch.launch.lowering import CostCounter
        def dt(shape, pl, mesh):
            local = list(shape)
            for m, p in enumerate(pl):
                if isinstance(p, Shard):
                    local[p.dim] //= mesh.size(m)
            return DTensor.from_local(torch.empty(local, device="meta"),
                                      mesh, pl, run_check=False,
                                      shape=torch.Size(shape),
                                      stride=torch.empty(shape,
                                                         device="meta")
                                      .stride())
        rows = []
        with fake_world(256):
            mesh = make_mesh((16, 16), ("data", "model"))
            c = CostCounter()
            with c:
                x = dt((2048, 8), [Shard(0), Shard(0)], mesh)
                y = x.view(16, 128, 8)
                z = y.reshape(2048, 8)
                w = dt((16, 64, 8), [Shard(1), Shard(0)], mesh)
                v = w.view(1024, 8)
                p = F.pad(dt((32, 64, 24), [Shard(0), Shard(1)], mesh),
                          (0, 8))
            for t in (y, z, v, p):
                rows.append([list(t.shape), str(t.placements),
                             list(t.to_local().shape)])
            rows.append([c.collective_bytes(), c.fallbacks])
        print(json.dumps(rows))
    """)
    y, z, v, p, (coll, fallbacks) = json.loads(out.strip().splitlines()[-1])
    assert y == [[16, 128, 8], "(Shard(dim=0), Shard(dim=1))", [1, 8, 8]]
    assert z == [[2048, 8], "(Shard(dim=0), Shard(dim=0))", [8, 8]]
    assert v == [[1024, 8], "(Shard(dim=0), Shard(dim=0))", [4, 8]]
    assert p == [[32, 64, 32], "(Shard(dim=0), Shard(dim=1))", [2, 4, 32]]
    assert coll == {"_counts": {}} and fallbacks == {}


def test_counter_lets_an_unknown_error_through():
    """Only DTensor's known refusals run replicated: a fault of the step
    (a view to a wrong size, a product of mismatched shapes) raises
    under the counter as it would without it. A refusal that is known
    (bincount has no sharding rule) runs replicated, is listed, and its
    all-gather of the ids is counted among the fallback's bytes."""
    out = _run("""
        import json, torch
        from torch.distributed.tensor import DTensor, Shard
        from repro_torch.launch.mesh import fake_world, make_mesh
        from repro_torch.launch.lowering import CostCounter, \\
            _register_meta_kernels
        _register_meta_kernels()
        errors = []
        with fake_world(8):
            mesh = make_mesh((4, 2), ("data", "model"))
            x = DTensor.from_local(torch.empty(8, 64, device="meta"), mesh,
                                   [Shard(0), Shard(1)], run_check=False,
                                   shape=torch.Size((32, 128)),
                                   stride=(128, 1))
            for bad in (lambda: x.view(3, 7), lambda: x @ x):
                try:
                    with CostCounter():
                        bad()
                    errors.append(None)
                except RuntimeError as e:
                    errors.append(type(e).__name__)
            ids = DTensor.from_local(
                torch.empty(8, dtype=torch.int64, device="meta"), mesh,
                [Shard(0), Shard(0)], run_check=False,
                shape=torch.Size((64,)), stride=(1,))
            c = CostCounter()
            with c:
                torch.bincount(ids, minlength=5)
        print(json.dumps([errors, c.fallbacks, c.collective_bytes(),
                          c.fallback_collective_bytes()]))
    """)
    errors, fallbacks, coll, fb_coll = json.loads(
        out.strip().splitlines()[-1])
    assert errors == ["RuntimeError", "RuntimeError"]
    assert fallbacks == {"aten.bincount.default (no sharding rule)": 1}
    assert fb_coll == {k: v for k, v in coll.items() if k != "_counts"}
    assert fb_coll["all-gather"] > 0
