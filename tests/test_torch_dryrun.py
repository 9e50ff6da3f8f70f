"""The port's dry-run CLIs on the CPU (no card): `launch.dryrun` writes an
`ok` record for deepseek-v3-671b's train_4k on the 16x16 mesh (a fake
256-rank group; the cost from the probes, the argument sizes from the
specs), with the keys of a record lowered whole (`--direct`),
whose per-device argument bytes are the local shards of the params and
the optimizer state; `launch.probes` and `launch.perf` write theirs for
yi-9b decode_32k, `perf` priced with the H100's constants by default and
the v5e's on request. The roofline terms of the dry-run record follow.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import SHAPES, registry
from repro_torch.roofline.analysis import H100_HW, roofline_terms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(module: str, *args: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-m", module, *args],
                       capture_output=True, text=True, timeout=900,
                       cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_dryrun_writes_an_ok_record_for_deepseek_train(tmp_path):
    out = _cli("repro_torch.launch.dryrun", "--arch", "deepseek-v3-671b",
               "--shape", "train_4k", "--mesh", "single", "--workers", "3",
               "--out", str(tmp_path))
    assert "dry-run complete: 0 failures" in out
    with open(tmp_path / "pod16x16__deepseek-v3-671b__train_4k.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["cost_from"] == "probes"
    # 671,026,419,200 bf16 params
    assert rec["params_bytes"] >= 2 * 671_026_419_200
    mem = rec["memory"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "alias_size_in_bytes", "temp_size_in_bytes",
                        "peak_memory_in_bytes"}
    assert mem["argument_size_in_bytes"] >= rec["params_bytes"] // 256
    assert mem["alias_size_in_bytes"] <= mem["output_size_in_bytes"]
    # the peak is the probes' extrapolated estimate, marked so
    assert rec["memory_estimated"] == ["temp_size_in_bytes",
                                       "peak_memory_in_bytes"]
    assert mem["peak_memory_in_bytes"] > mem["argument_size_in_bytes"]
    # the ops run replicated: the MoE's dispatch, named, and a small part
    # of the collective bytes
    assert "aten.bincount.default (no sharding rule)" in rec["fallbacks"]
    coll = sum(v for k, v in rec["collectives"].items() if k != "_counts")
    assert 0 < rec["fallback_collective_bytes"] < 0.01 * coll
    parts = rec["arguments"]
    assert sum(parts.values()) == mem["argument_size_in_bytes"]
    assert parts["params"] >= rec["params_bytes"] // 256
    assert rec["cost"]["flops"] > 0
    assert coll > 0 and rec["collectives"]["_counts"]["all-gather"] > 0
    cfg = registry.get_config("deepseek-v3-671b")
    row = roofline_terms(rec, cfg, SHAPES["train_4k"], H100_HW)
    assert row.compute_s > 0 and row.dominant in ("compute", "memory",
                                                  "collective")


def test_probes_and_perf_write_their_records(tmp_path):
    out = _cli("repro_torch.launch.probes", "--arch", "yi-9b", "--shape",
               "decode_32k", "--out", str(tmp_path / "probes"))
    assert "probes complete: 0 failures" in out
    with open(tmp_path / "probes" / "pod16x16__yi-9b__decode_32k.json") as f:
        rec = json.load(f)
    assert rec["corrected"]["flops"] > 0
    assert set(rec["probes"]) == {"P1", "P2_0"}
    for hw in ("h100", "v5e"):
        out = _cli("repro_torch.launch.perf", "--arch", "yi-9b", "--shape",
                   "decode_32k", "--tag", "t", "--hw", hw, "--out",
                   str(tmp_path / "perf"))
        assert f"terms ({hw}):" in out
    with open(tmp_path / "perf" / "yi-9b__decode_32k.jsonl") as f:
        h100, v5e = [json.loads(line) for line in f]
    assert h100["corrected"] == v5e["corrected"] == rec["corrected"]
    # the same counts over 197 vs 989 TF/s
    assert v5e["compute_s"] / h100["compute_s"] == pytest.approx(989 / 197)


def test_direct_and_probe_records_have_the_same_keys():
    """`lower_record` of a smoke prefill and train cell on a 2x4 mesh,
    whole (`direct=True`) and by probes: the same keys, and the same
    argument, output and alias sizes, costs, collectives (with their
    counts), and fallback bytes; the peak is an estimate either way."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-c", """
import json
from repro_torch.launch.dryrun import lower_record
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models import registry
from repro_torch.models.config import ShapeSpec
out = []
with fake_world(8):
    mesh = make_mesh((2, 4), ("data", "model"))
    for arch, shape in (("yi-9b", ShapeSpec("p", 64, 8, "prefill")),
                        ("granite-moe-3b-a800m",
                         ShapeSpec("t", 64, 8, "train"))):
        cfg = registry.get_smoke_config(arch)
        out.append([lower_record(arch, cfg, shape, mesh, "t", direct=d)
                    for d in (True, False)])
print(json.dumps(out))
"""], capture_output=True, text=True, timeout=900, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    for direct, probes in json.loads(r.stdout.strip().splitlines()[-1]):
        assert set(direct) == set(probes)
        assert (direct["cost_from"], probes["cost_from"]) == ("direct",
                                                              "probes")
        assert set(direct["memory"]) == set(probes["memory"])
        for k in ("argument_size_in_bytes", "output_size_in_bytes",
                  "alias_size_in_bytes"):
            assert direct["memory"][k] == probes["memory"][k], k
        for k in ("arguments", "collectives", "memory_estimated",
                  "params_bytes", "devices"):
            assert direct[k] == probes[k], k
        for k, v in direct["cost"].items():
            assert probes["cost"][k] == pytest.approx(v, rel=1e-6), k
        assert probes["fallback_collective_bytes"] == pytest.approx(
            direct["fallback_collective_bytes"], rel=1e-6)
        assert set(direct["fallbacks"]) == set(probes["fallbacks"])


def test_probes_in_worker_processes_count_the_same():
    """`measure_corrected` with its probes lowered in two processes of
    their own (each its own fake 2x4 group) gives the record it gives
    in this one: a smoke train cell of granite-moe-3b-a800m, whose MoE
    runs ops replicated."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-c", """
import json
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models import registry
from repro_torch.models.config import ShapeSpec
from repro_torch.roofline.probes import measure_corrected
cfg = registry.get_smoke_config("granite-moe-3b-a800m")
shape = ShapeSpec("t", 64, 8, "train")
with fake_world(8):
    mesh = make_mesh((2, 4), ("data", "model"))
    recs = [measure_corrected("g", cfg, shape, mesh, "t", workers=w,
                              log=lambda *a: None) for w in (1, 2)]
print(json.dumps(recs))
"""], capture_output=True, text=True, timeout=900, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    one, two = json.loads(r.stdout.strip().splitlines()[-1])
    assert one == two
    assert one["fallbacks"] and one["corrected"]["flops"] > 0
