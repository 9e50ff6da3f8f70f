"""The port's roofline machinery (repro_torch.roofline, the counting of
repro_torch.launch.lowering): twins of tests/test_roofline.py's jax-free
tests (MODEL_FLOPS, the probe algebra, the fused-memory estimate, the v5e
constants), the H100 constants beside them, the counter's per-device
counts against a hand count on a 4x2 fake mesh, every smoke forward's
counted products on a 1x1 mesh against its imported program's DOT FLOPs
(which tests/test_torch_hlo_import.py holds equal to the reference's
jaxpr), and the probe extrapolation against the direct count on three
smoke cells. A fake process group lives only in a subprocess here.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import SHAPES, get_config
from repro_torch.models import registry
from repro_torch.roofline.analysis import (
    H100_HW,
    ROOFLINE_HW,
    RooflineRow,
    active_param_count,
    analytic_memory_bytes,
    model_flops,
    render_markdown,
    roofline_terms,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, timeout: int = 600) -> str:
    """Runs `code` in a fresh interpreter (its fake process group never
    meets another) and returns its standard output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# twins of tests/test_roofline.py
# ---------------------------------------------------------------------------
def test_active_params_moe_vs_dense():
    dense = get_config("yi-9b")
    moe = get_config("granite-moe-3b-a800m")
    nd = 8_800_000_000
    assert active_param_count(dense, nd) == nd        # dense: all active
    nm = 3_300_000_000
    act = active_param_count(moe, nm)
    assert act < 0.45 * nm                            # 8/40 experts active


def test_model_flops_train_vs_decode_scaling():
    cfg = get_config("yi-9b")
    n = 8_800_000_000
    tr = model_flops(cfg, SHAPES["train_4k"], n)
    de = model_flops(cfg, SHAPES["decode_32k"], n)
    # train: 6·N·(256×4096) tokens; decode: 2·N·128 tokens
    assert tr / de == pytest.approx(
        (6 * 256 * 4096) / (2 * 128), rel=0.35)       # lm-head term skews


def test_probe_extrapolation_algebra():
    """The train correction F = O + m(H + Σ L_s C_s) recovers ground truth
    from synthetic P1/P2/P3 measurements."""
    O, H, C = 7.0, 11.0, 3.0            # one stack

    def F(m, L):
        return O + m * (H + L * C)
    P1, P2, P3 = F(1, 1), F(1, 2), F(2, 1)
    C_est = P2 - P1
    O_est = 2 * P1 - P3
    per_micro = P1 - O_est
    m, L = 16, 61
    corrected = O_est + m * (per_micro + (L - 1) * C_est)
    assert corrected == pytest.approx(F(m, L))


def test_fused_memory_estimate_ordering():
    """Decode moves far fewer bytes than train; SWA decode beats full-attn
    decode at the same size class."""
    yi = get_config("yi-9b")
    danube = get_config("h2o-danube-3-4b")
    n_yi, n_da = 8.8e9, 4e9
    tr = analytic_memory_bytes(yi, SHAPES["train_4k"], n_yi)
    de = analytic_memory_bytes(yi, SHAPES["decode_32k"], n_yi)
    assert tr > 10 * de
    de_swa = analytic_memory_bytes(danube, SHAPES["decode_32k"], n_da)
    # same-ballpark params, but window cache << 32k full cache
    assert de_swa < de


def test_roofline_terms_use_v5e_constants():
    assert ROOFLINE_HW["peak_flops"] == 197e12
    assert ROOFLINE_HW["hbm_bw"] == 819e9
    assert ROOFLINE_HW["ici_bw"] == 50e9


# ---------------------------------------------------------------------------
# the copied analysis against the reference's (repro.roofline.analysis is
# jax-free), on the same inputs
# ---------------------------------------------------------------------------
from repro.models import registry as jreg  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402

FULL_ARCHS = sorted(registry.ARCHS)


def _params(arch: str) -> int:
    from repro_torch.models import lm
    return lm.analytic_param_count(get_config(arch))


def _cell_record(arch: str, shape_name: str, n: int) -> dict:
    """A dry-run record of the port's keys with made-up per-device counts
    (no lowering): both packages price the same dict."""
    return {"arch": arch, "shape": shape_name, "mesh": "pod16x16",
            "devices": 256, "params_bytes": 2 * n, "status": "ok",
            "cost": {"flops": 1.5e14 + n, "bytes accessed": 2.5e12},
            "collectives": {"all-gather": 3.0e10, "all-reduce": 1.0e9,
                            "reduce-scatter": 7.0e8, "all-to-all": 2.0e8,
                            "_counts": {"all-gather": 9}},
            "memory": {"argument_size_in_bytes": n // 100,
                       "output_size_in_bytes": n // 200,
                       "alias_size_in_bytes": n // 300,
                       "temp_size_in_bytes": n // 50,
                       "peak_memory_in_bytes": n // 40 + 7}}


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", FULL_ARCHS)
def test_analysis_matches_the_reference(arch, shape_name):
    """MODEL_FLOPS, the active params, the fused-memory estimate and the
    roofline terms (the v5e constants) equal the reference's for the
    arch's full config and its analytic param count."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    jcfg, jshape = jreg.get_config(arch), JSHAPES[shape_name]
    n = _params(arch)
    assert active_param_count(cfg, n) == janalysis.active_param_count(jcfg,
                                                                       n)
    assert model_flops(cfg, shape, n) == janalysis.model_flops(jcfg, jshape,
                                                               n)
    assert analytic_memory_bytes(cfg, shape, n) == \
        janalysis.analytic_memory_bytes(jcfg, jshape, n)
    rec = _cell_record(arch, shape_name, n)
    for memory in (rec["memory"], {k: v for k, v in rec["memory"].items()
                                   if k != "peak_memory_in_bytes"}):
        r = dict(rec, memory=memory)
        assert dataclasses.astuple(roofline_terms(r, cfg, shape,
                                                  ROOFLINE_HW)) == \
            dataclasses.astuple(janalysis.roofline_terms(r, jcfg, jshape))


def test_render_markdown_matches_the_reference_but_its_header():
    """Every row of the table as the reference renders it; the header
    names the memory the "fits" column was checked against."""
    rows, jrows = [], []
    for arch in FULL_ARCHS:
        n = _params(arch)
        for shape_name in sorted(SHAPES):
            rec = _cell_record(arch, shape_name, n)
            rows.append(roofline_terms(rec, get_config(arch),
                                       SHAPES[shape_name]))
            jrows.append(janalysis.roofline_terms(
                rec, jreg.get_config(arch), JSHAPES[shape_name]))
    ours = render_markdown(rows).splitlines()
    ref = janalysis.render_markdown(jrows).splitlines()
    assert len(ours) == len(ref) == 2 + len(FULL_ARCHS) * len(SHAPES)
    assert ours[1:] == ref[1:]
    assert ours[0].replace("fits 16 GiB", "fits 16G") == ref[0]


class _Stub:
    """A lowering's counts from a made-up cost model of the cell,
    F_k(m, L) = R_k(m) + O_k + Σ_s L_s·U_sk
                + m·(H_k + Σ_s (L_s·C_sk + L_s²·Q_sk))
    for the k-th of the reference's eight metrics, for `measure_corrected`
    of both packages (the reference's model is U = Q = R = 0). m is the
    cell's global batch over the config's microbatch; R moves nothing at
    one microbatch."""

    def __init__(self, U=0.0, Q=0.0, R=0.0):
        self.U, self.Q, self.R = U, Q, R

    @staticmethod
    def _m(cfg, shape) -> int:
        return shape.global_batch // cfg.microbatch \
            if shape.kind == "train" else 1

    def split(self, cfg, shape, k: int) -> float:
        m = self._m(cfg, shape)
        return self.R * k * m if m > 1 else 0.0

    def metric(self, cfg, shape, k: int) -> float:
        reps = [st.repeats for st in cfg.stacks]
        n = range(len(reps))
        per_micro = 50.0 * k + 3 + sum(
            L * (10.0 + 3 * s) * k + L * L * self.Q * (s + 2) * k
            for s, L in zip(n, reps))
        return (self.split(cfg, shape, k) + 1000.0 * k + 7
                + sum(L * self.U * (s + 1) * k for s, L in zip(n, reps))
                + self._m(cfg, shape) * per_micro)

    def cell(self, arch, cfg, shape, mesh, mesh_name):
        from types import SimpleNamespace
        v = [self.metric(cfg, shape, k) for k in range(1, 9)]
        return SimpleNamespace(
            cost_analysis={"flops": v[0], "bytes accessed": v[1],
                           "transcendentals": v[2]},
            collective_bytes=dict(zip(KINDS, v[3:]), _counts={}),
            fallbacks={}, fallback_collectives={},
            memory_analysis=SimpleNamespace(output_size_in_bytes=0,
                                            peak_memory_in_bytes=0))

    def lower_split(self, cfg, shape, mesh):
        from types import SimpleNamespace
        v = [self.split(cfg, shape, k) for k in range(1, 9)]
        return SimpleNamespace(
            cost_analysis=lambda: {"flops": v[0], "bytes accessed": v[1],
                                   "transcendentals": v[2]},
            collective_bytes=lambda: dict(zip(KINDS, v[3:]), _counts={}),
            fallback_collective_bytes=lambda: {})

    def patch(self, monkeypatch):
        import repro.launch.lowering as jlowering
        import repro_torch.launch.lowering as tlowering
        monkeypatch.setattr(jlowering, "lower_cell", self.cell)
        monkeypatch.setattr(tlowering, "lower_cell", self.cell)
        monkeypatch.setattr(tlowering, "lower_microbatch_split",
                            self.lower_split)


KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


PROBE_ALGEBRA_CELLS = [("deepseek-v3-671b", "train_4k"),
                       ("yi-9b", "decode_32k"),
                       ("recurrentgemma-9b", "prefill_32k")]


@pytest.mark.parametrize("arch,shape_name", PROBE_ALGEBRA_CELLS)
def test_probe_algebra_matches_the_reference(monkeypatch, arch,
                                             shape_name):
    """`measure_corrected` of both packages over the same stubbed
    lowering (the reference's linear model): the same per-layer costs and
    the same corrected counts (the port's probes hold two layers a stack
    where the reference's hold one)."""
    from repro.roofline import probes as jprobes
    from repro_torch.roofline import probes as tprobes

    _Stub().patch(monkeypatch)
    quiet = dict(log=lambda *a: None)
    ours = tprobes.measure_corrected(arch, get_config(arch),
                                     SHAPES[shape_name], None, "m", **quiet)
    ref = jprobes.measure_corrected(arch, jreg.get_config(arch),
                                    JSHAPES[shape_name], None, "m", **quiet)
    for k, v in ref["corrected"].items():
        assert ours["corrected"][k] == v, k
    # a stack of two layers or fewer needs no probe of its own
    for st, c_ours, c_ref in zip(get_config(arch).stacks,
                                 ours["per_stack_layer"],
                                 ref["per_stack_layer"]):
        for k, v in c_ref.items():
            assert c_ours[k] == (v if st.repeats > 2 else 0.0), k


@pytest.mark.parametrize("U,Q,R", [(4.0, 0.0, 0.0), (0.0, 0.5, 0.0),
                                   (0.0, 0.0, 5.0), (4.0, 0.5, 5.0)])
def test_probe_algebra_holds_the_ports_train_model(monkeypatch, U, Q, R):
    """With a layer cost once a step (U: the optimizer's update), one a
    microbatch that grows with the square of a stack's depth (Q: each
    layer's view of a stacked param scatters its gradient into a zero
    tensor of the whole stack) and a microbatch split that moves nothing
    at one microbatch (R), the port's algebra gives the stub's own count
    of the full cell, which the reference's (U = Q = R = 0) does not."""
    from repro.roofline import probes as jprobes
    from repro_torch.roofline import probes as tprobes

    stub = _Stub(U=U, Q=Q, R=R)
    stub.patch(monkeypatch)
    cfg, shape = get_config("deepseek-v3-671b"), SHAPES["train_4k"]
    quiet = dict(log=lambda *a: None)
    ours = tprobes.measure_corrected("a", cfg, shape, None, "m", **quiet)
    ref = jprobes.measure_corrected("a", jreg.get_config("deepseek-v3-671b"),
                                    JSHAPES["train_4k"], None, "m", **quiet)
    for i, k in enumerate(tprobes.METRICS):
        truth = stub.metric(cfg, shape, i + 1)
        assert ours["corrected"][k] == pytest.approx(truth, rel=1e-12), k
        assert ref["corrected"][k] != pytest.approx(truth, rel=1e-6), k


# ---------------------------------------------------------------------------
# the H100's constants
# ---------------------------------------------------------------------------
def _record():
    return {"arch": "yi-9b", "shape": "train_4k", "mesh": "pod16x16",
            "devices": 256, "params_bytes": 2 * 8_800_000_000,
            "cost": {"flops": 9.89e14, "bytes accessed": 3.35e12},
            "collectives": {"all-gather": 2.5e10, "all-reduce": 2.5e10,
                            "_counts": {"all-gather": 3}},
            "memory": {"argument_size_in_bytes": 70 * 10**9,
                       "output_size_in_bytes": 0,
                       "alias_size_in_bytes": 0}}


def test_h100_terms_price_one_card_of_a_node():
    """989 TF/s bf16 dense, 3.35 TB/s, one 400 Gb/s NIC a card for the
    collective term (a 16-wide axis leaves the node), 80 GB."""
    assert H100_HW["peak_flops"] == 989e12
    assert H100_HW["hbm_bw"] == 3.35e12
    assert H100_HW["link_bw"] == 50e9
    assert H100_HW["nvlink_bw"] == 450e9
    assert H100_HW["hbm_bytes"] == 80e9
    cfg, shape = get_config("yi-9b"), SHAPES["train_4k"]
    row = roofline_terms(_record(), cfg, shape, H100_HW)
    assert row.compute_s == pytest.approx(1.0)
    assert row.memory_s == pytest.approx(1.0)
    assert row.collective_s == pytest.approx(1.0)     # 5e10 B / 50 GB/s
    assert row.fits_hbm                              # 70 GB <= 80 GB
    v5e = roofline_terms(_record(), cfg, shape)
    assert v5e.compute_s == pytest.approx(9.89e14 / 197e12)
    assert not v5e.fits_hbm                          # 70 GB > 16 GiB
    assert row.hlo_flops_total == 9.89e14 * 256
    assert row.useful_ratio == pytest.approx(
        model_flops(cfg, shape, 8_800_000_000) / (9.89e14 * 256))


def test_render_markdown_header_names_the_memory_checked():
    row = RooflineRow("a", "s", "m", 1, 1.0, 2.0, 3.0, "collective", 1.0,
                      1.0, 1.0, 1.0, True)
    assert "fits 16 GiB |" in render_markdown([row]).splitlines()[0]
    h100 = render_markdown([row], H100_HW)
    assert "fits 80 GB |" in h100.splitlines()[0]
    assert h100.splitlines()[2].endswith("| yes |")


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------
def test_counter_counts_one_device_on_a_4x2_mesh():
    """x [32, 64] rows over data (4) @ w [64, 256] columns over model (2):
    each device multiplies [8, 64] @ [64, 128]. Then a product whose
    contraction dim is split over model gives a Partial sum, and its
    all-reduce moves one device's [8, 256] f32 output."""
    out = _last_json(_run("""
        import json, torch
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch.mesh import fake_world, make_mesh
        from repro_torch.launch.lowering import CostCounter
        def dt(shape, local, pl, mesh):
            return DTensor.from_local(torch.empty(local, device="meta"),
                                      mesh, pl, run_check=False,
                                      shape=torch.Size(shape),
                                      stride=(shape[1], 1))
        with fake_world(8):
            mesh = make_mesh((4, 2), ("data", "model"))
            x = dt((32, 64), (8, 64), [Shard(0), Replicate()], mesh)
            w = dt((64, 256), (64, 128), [Replicate(), Shard(1)], mesh)
            a = CostCounter()
            with a:
                y = x @ w
            xs = dt((32, 64), (8, 32), [Shard(0), Shard(1)], mesh)
            ws = dt((64, 256), (32, 256), [Replicate(), Shard(0)], mesh)
            b = CostCounter()
            with b:
                z = (xs @ ws).redistribute(mesh, [Shard(0), Replicate()])
            print(json.dumps({
                "a": [a.flops, a.bytes, a.collective_bytes()],
                "y": [list(y.to_local().shape), str(y.placements)],
                "b": [b.flops, b.collective_bytes()],
                "z": list(z.to_local().shape)}))
    """))
    flops, nbytes, coll = out["a"]
    assert flops == 2 * 8 * 64 * 128
    assert nbytes == 4 * (8 * 64 + 64 * 128 + 8 * 128)
    assert coll == {"_counts": {}}
    assert out["y"][0] == [8, 128]
    flops, coll = out["b"]
    assert flops == 2 * 8 * 32 * 256
    assert coll["all-reduce"] == 4 * 8 * 256
    assert coll["_counts"] == {"all-reduce": 1}
    assert out["z"] == [8, 256]


def _dot_flops(graph) -> int:
    return sum(2 * n.contract_dim * math.prod(n.shape)
               for n in graph.nodes if n.op.name == "dot")


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_counted_forward_flops_match_imported_dots(arch):
    """On a 1x1 mesh the counter's products of a smoke forward (`loss_fn`
    at 2 x 64 tokens) equal the imported program's DOT FLOPs. The
    importer records each loop's first iteration (the reference's scan
    body), so both run the smoke config with every loop once: one layer
    a stack, one KV block, one SSD chunk."""
    from repro_torch.core import hlo_import as H
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.inputs import make_batch

    out = _last_json(_run(f"""
        import json, torch
        from torch.distributed.tensor.experimental import \\
            implicit_replication
        from repro_torch.launch.mesh import fake_world, make_mesh
        from repro_torch.launch.lowering import CostCounter, \\
            _register_meta_kernels
        from repro_torch.models import lm
        from repro_torch.models.config import ShapeSpec
        from repro_torch.models.inputs import input_specs
        from repro_torch.sharding import partition
        from tests.test_torch_roofline import one_pass_config
        cfg = one_pass_config({arch!r})
        shape = ShapeSpec("import", 64, 2, "train")
        _register_meta_kernels()
        with fake_world(1):
            mesh = make_mesh((1, 1), ("data", "model"))
            p, b = lm.init_abstract(cfg), input_specs(cfg, shape)
            pd = partition.abstract_with_sharding(
                p, partition.param_specs(cfg, p, mesh), mesh)
            bd = partition.abstract_with_sharding(
                b, partition.batch_specs(b, mesh), mesh)
            c = CostCounter()
            with torch.no_grad(), implicit_replication(), c:
                lm.loss_fn(pd, cfg, bd)
        print(json.dumps([c.flops, c.collective_bytes()]))
    """))
    cfg = one_pass_config(arch)
    shape = ShapeSpec("import", 64, 2, "train")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    graph = H.import_fn(lambda p, b: lm.loss_fn(p, cfg, b), params,
                        make_batch(cfg, shape, device="cpu"))
    assert out[0] == _dot_flops(graph) - EINSUM_ORDER.get(arch, 0) > 0
    assert out[1] == {"_counts": {}}           # one device: no collective


# FLOPs the importer's DOTs hold beyond the products torch runs: the
# importer records a three-operand einsum in jnp.einsum's pairwise order,
# torch.einsum contracts it in its own. The SSD's two ("bcln,bclh,bclhp->
# bchnp" and "bcln,bclh,bchnp->bclhp") take 278528 FLOPs each in the
# importer's order and 262144 in torch's at one 64-step chunk.
EINSUM_ORDER = {"mamba2-2.7b": 2 * (278528 - 262144)}


def one_pass_config(arch: str):
    """`arch`'s smoke config with every loop of a 64-token forward run
    once: one layer a stack, one KV block, one SSD chunk."""
    import dataclasses

    from repro_torch.roofline.probes import _probe_cfg
    cfg = registry.get_smoke_config(arch)
    cfg = _probe_cfg(cfg, [1] * len(cfg.stacks))
    cfg = dataclasses.replace(cfg, block_kv=64)
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               chunk=64))
    return cfg


# (arch, shape, each stack's depth): deeper than the smoke configs' one
# or two layers a stack, so that the probes extrapolate over the layers
PROBE_CELLS = {
    "train": ("h2o-danube-3-4b", ("t", 64, 8, "train"), [5]),
    "prefill": ("deepseek-v3-671b", ("p", 64, 8, "prefill"), [2, 4]),
    "decode": ("recurrentgemma-9b", ("d", 64, 8, "decode"), [3, 2]),
}


@pytest.mark.parametrize("kind", sorted(PROBE_CELLS))
def test_probes_match_the_direct_count(kind):
    """`measure_corrected` (two or three layers a stack, one or two
    microbatches) against the whole cell lowered directly, the smoke
    config at the depths above, on a 2x4 mesh (the smoke microbatch of 2
    splits over its dp of 2): every metric, the FLOPs, bytes,
    transcendentals, each collective's bytes and count and the bytes of
    the ops run replicated. Prefill and decode exactly; train within
    1e-6 (its optimizer update, its gradient's cost quadratic in the
    depth and its microbatch split are terms of their own, see
    `roofline.probes`). The output size, which the probes extrapolate
    over the layers, exactly."""
    arch, shape, depth = PROBE_CELLS[kind]
    out = _last_json(_run(f"""
        import json
        from repro_torch.launch.mesh import fake_world, make_mesh
        from repro_torch.launch.lowering import lower_cell
        from repro_torch.models import registry
        from repro_torch.models.config import ShapeSpec
        from repro_torch.roofline.probes import _cell_metrics, \\
            measure_corrected
        from repro_torch.roofline.probes import _probe_cfg
        cfg = _probe_cfg(registry.get_smoke_config({arch!r}), {depth!r})
        shape = ShapeSpec(*{shape!r})
        with fake_world(8):
            mesh = make_mesh((2, 4), ("data", "model"))
            cell = lower_cell({arch!r}, cfg, shape, mesh, "t")
            rec = measure_corrected({arch!r}, cfg, shape, mesh, "t",
                                    log=lambda *a: None)
        print(json.dumps([_cell_metrics(cell), rec["corrected"],
                          cell.memory_analysis.output_size_in_bytes,
                          rec["memory"]["output_size_in_bytes"]]))
    """))
    direct, corrected, out_direct, out_probes = out
    assert direct["flops"] > 0
    assert sum(direct[k] for k in ("all-gather", "all-reduce",
                                   "reduce-scatter", "all-to-all")) > 0
    assert set(direct) < set(corrected)
    for k in direct:
        if kind == "train":
            assert corrected[k] == pytest.approx(direct[k], rel=1e-6), k
        else:
            assert corrected[k] == direct[k], k
    assert out_probes == out_direct


def test_microbatch_split_is_the_term_not_linear_in_m():
    """The train step's microbatch split alone (`lower_microbatch_split`)
    on a 2x4 mesh, at 1, 2 and 4 microbatches of h2o-danube-3-4b's smoke
    config (microbatch 2): none at one microbatch (the [1, mb] view keeps
    the batch's sharding over dp), and at two or more one all-to-all of
    the batch from its leading dim to the microbatch dim, a device's
    share of the tokens, and nothing else."""
    out = _last_json(_run("""
        import json
        from repro_torch.launch.mesh import fake_world, make_mesh
        from repro_torch.launch.lowering import lower_microbatch_split
        from repro_torch.models import registry
        from repro_torch.models.config import ShapeSpec
        cfg = registry.get_smoke_config("h2o-danube-3-4b")
        rows = []
        with fake_world(8):
            mesh = make_mesh((2, 4), ("data", "model"))
            for m in (1, 2, 4):
                c = lower_microbatch_split(
                    cfg, ShapeSpec("t", 64, 2 * m, "train"), mesh)
                rows.append([m, c.flops, c.bytes, c.collective_bytes(),
                             c.fallbacks])
        print(json.dumps(rows))
    """))
    for m, flops, nbytes, coll, fallbacks in out:
        assert flops == 0 and fallbacks == {}
        if m == 1:
            assert coll == {"_counts": {}} and nbytes == 0
        else:
            # int64 tokens [2m, 64] over dp = 2
            assert coll == {"all-to-all": 8.0 * 2 * m * 64 / 2,
                            "_counts": {"all-to-all": 1}}
