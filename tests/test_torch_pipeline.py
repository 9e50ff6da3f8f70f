"""The port's GPipe schedule, against sequential application and the JAX
package.

`repro_torch.training.pipeline.pipeline_apply` over 4 gloo ranks (one
stage each, `repro_torch.sharding.spawn_ranks`) on the setting of
tests/test_distributed.py's `test_pipeline_parallel_matches_sequential`
(8 layers of tanh(x @ W), D=16, 6 microbatches of 2), with inputs made by
numpy from a seed; the reference's `pipeline_apply` runs on a 4-device
host mesh in a subprocess with
XLA_FLAGS=--xla_force_host_platform_device_count=4. Every rank must
return the final stage's outputs, equal on all ranks, within 1e-5 of
sequential application (the reference's tolerance) and of the reference.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.sharding import spawn_ranks
from repro_torch.training.pipeline import pipeline_stage_split
from tests import _torch_dist_workers as W

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
L, D, M, MB, STAGES = 8, 16, 6, 2, 4
TOL = 1e-5

JAX_PIPE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.training.pipeline import pipeline_apply, pipeline_stage_split

z = np.load(sys.argv[1])
Ws, x = jnp.asarray(z["Ws"]), jnp.asarray(z["x"])
mesh = jax.make_mesh((4,), ("stage",))

def stage_fn(stage_params, x):
    def body(h, w):
        return jnp.tanh(h @ w), None
    h, _ = jax.lax.scan(body, x, stage_params)
    return h

y = pipeline_apply(stage_fn, pipeline_stage_split(Ws, 4), x, mesh=mesh,
                   axis="stage")
np.save(sys.argv[2], np.asarray(y))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    Ws = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    d = tmp_path_factory.mktemp("pipeline")
    inputs = str(d / "inputs.npz")
    np.savez(inputs, Ws=Ws, x=x)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_PIPE),
                          inputs, str(d / "jax.npy")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    spawn_ranks(W.pipeline_ranks, (str(d), inputs), STAGES, device="cpu")
    seq = torch.from_numpy(x)
    for w in torch.from_numpy(Ws):
        seq = torch.tanh(seq @ w)
    return ([np.load(d / f"rank{r}.npy") for r in range(STAGES)],
            np.load(d / "jax.npy"), seq.numpy())


@pytest.mark.timeout(300)
def test_pipeline_matches_sequential_on_every_rank(runs):
    port, _, seq = runs
    for y in port:
        assert y.shape == (M, MB, D)
        assert float(np.abs(y - seq).max()) < TOL
        assert y.tobytes() == port[0].tobytes()


@pytest.mark.timeout(300)
def test_pipeline_matches_the_reference(runs):
    port, ref, _ = runs
    assert float(np.abs(port[0] - ref).max()) < TOL


def test_stage_split_reshapes_every_leaf():
    tree = {"w": torch.arange(24.0).reshape(8, 3), "b": [torch.zeros(8)]}
    out = pipeline_stage_split(tree, 4)
    assert out["w"].shape == (4, 2, 3) and out["b"][0].shape == (4, 2)
    assert torch.equal(out["w"][1, 0], tree["w"][2])
    with pytest.raises(ValueError, match="do not split"):
        pipeline_stage_split(tree, 3)
