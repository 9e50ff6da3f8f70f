"""The port's int8 error-feedback all-reduce, against the JAX package.

`repro_torch.training.compression` on the same inputs (numpy, from a
seed) as `repro.training.compression`: on one device (`group=None` /
`axis_name=None`) in this process, and over 2 ranks (gloo,
`repro_torch.sharding.spawn_ranks`) against the reference under
`shard_map` on a 2-device host mesh, which runs in a subprocess with
XLA_FLAGS=--xla_force_host_platform_device_count=2. Int8 codes, and the
int32 sums recovered from the reduced gradients, must agree exactly;
the floats within 1e-6 of the reference's largest |value|.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.training import compression as JCmp
from repro_torch.sharding import spawn_ranks
from repro_torch.training import compression as PCmp
from tests import _torch_dist_workers as W

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL = 1e-6
SHAPES = {"a": (8,), "b": (5, 7), "c": (3, 4, 6)}

JAX_TWO = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.sharding.context import shard_map_nocheck
from repro.training.compression import compressed_allreduce

inputs, out = sys.argv[1], sys.argv[2]
z = np.load(inputs)
names = sorted(k[3:] for k in z.files if k.startswith("g0_"))
g = {n: jnp.stack([z[f"g{r}_{n}"] for r in range(2)]) for n in names}
e = {n: jnp.stack([z[f"e{r}_{n}"] for r in range(2)]) for n in names}
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

def f(g, e):
    red, err = compressed_allreduce({n: g[n][0] for n in names},
                                    {n: e[n][0] for n in names}, "data")
    return ({n: red[n][None] for n in names},
            {n: err[n][None] for n in names})

spec = {n: P("data") for n in names}
red, err = shard_map_nocheck(f, mesh, in_specs=(spec, spec),
                             out_specs=(spec, spec))(g, e)
np.savez(out, **{f"red{r}_{n}": np.asarray(red[n][r]) for n in names
                 for r in range(2)},
         **{f"err{r}_{n}": np.asarray(err[n][r]) for n in names
            for r in range(2)})
"""


def _tree(rng, scale=1.0):
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _close(got, want):
    want = np.asarray(want)
    assert float(np.abs(np.asarray(got) - want).max()) <= \
        RTOL * max(float(np.abs(want).max()), 1e-30)


def _sums(red, g_plus_e_per_rank, n):
    """The int32 sum of codes behind `red` (exact: |sum| <= 127 n)."""
    amax = max(float(np.abs(x).max()) for x in g_plus_e_per_rank)
    scale = np.maximum(np.float32(amax) / np.float32(127.0),
                       np.float32(1e-12))
    return np.rint(np.asarray(red, np.float64) * n / scale).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_int8_codes_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(257) * 10.0 ** rng.uniform(-4, 2)).astype(
        np.float32)
    scale = np.maximum(np.abs(g).max() / np.float32(127.0),
                       np.float32(1e-12)).astype(np.float32)
    jq, jerr = JCmp.compress_int8(jnp.asarray(g), jnp.asarray(scale))
    pq, perr = PCmp.compress_int8(torch.from_numpy(g),
                                  torch.tensor(scale))
    assert pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    _close(perr.numpy(), jerr)
    _close(PCmp.decompress_int8(pq, torch.tensor(scale)).numpy(),
           JCmp.decompress_int8(jq, jnp.asarray(scale)))


@pytest.mark.parametrize("seed", [0, 1])
def test_compressed_allreduce_one_device_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    g, e = _tree(rng), _tree(rng, 0.01)
    jred, jerr = JCmp.compressed_allreduce(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in e.items()}, None)
    pred, perr = PCmp.compressed_allreduce(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in e.items()})
    for k in SHAPES:
        _close(pred[k].numpy(), jred[k])
        _close(perr[k].numpy(), jerr[k])
        ge = [g[k] + e[k]]
        np.testing.assert_array_equal(_sums(pred[k].numpy(), ge, 1),
                                      _sums(np.asarray(jred[k]), ge, 1))


@pytest.fixture(scope="module")
def two_rank_inputs(tmp_path_factory):
    """Per-rank trees: the reference test's setting (arange(16) / 7 split
    over the ranks, zero feedback) and random leaves with feedback."""
    rng = np.random.default_rng(7)
    arrays = {}
    for r in range(2):
        g, e = _tree(rng), _tree(rng, 0.01)
        g["ref"] = (np.arange(16, dtype=np.float32).reshape(2, 8)[r]
                    / np.float32(7.0))
        e["ref"] = np.zeros(8, np.float32)
        arrays.update({f"g{r}_{k}": v for k, v in g.items()})
        arrays.update({f"e{r}_{k}": v for k, v in e.items()})
    path = str(tmp_path_factory.mktemp("compress") / "inputs.npz")
    np.savez(path, **arrays)
    return path, arrays


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory, two_rank_inputs):
    path, _ = two_rank_inputs
    jout = str(tmp_path_factory.mktemp("compress_jax") / "jax.npz")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_TWO),
                          path, jout], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    pout = str(tmp_path_factory.mktemp("compress_port"))
    spawn_ranks(W.compress_ranks, (pout, path), 2, device="cpu")
    port = [dict(np.load(os.path.join(pout, f"rank{r}.npz")))
            for r in range(2)]
    return dict(np.load(jout)), port


@pytest.mark.timeout(300)
@pytest.mark.parametrize("leaf", sorted(SHAPES) + ["ref"])
def test_compressed_allreduce_two_ranks_matches_the_reference(
        leaf, two_rank_inputs, two_rank_runs):
    _, arrays = two_rank_inputs
    jax_out, port = two_rank_runs
    ge = [arrays[f"g{r}_{leaf}"] + arrays[f"e{r}_{leaf}"] for r in range(2)]
    for r in range(2):
        _close(port[r][f"red_{leaf}"], jax_out[f"red{r}_{leaf}"])
        _close(port[r][f"err_{leaf}"], jax_out[f"err{r}_{leaf}"])
        np.testing.assert_array_equal(
            _sums(port[r][f"red_{leaf}"], ge, 2),
            _sums(jax_out[f"red{r}_{leaf}"], ge, 2))
    # the ranks hold one reduced gradient; it is the mean within a step
    assert port[0][f"red_{leaf}"].tobytes() == \
        port[1][f"red_{leaf}"].tobytes()
    scale = max(float(np.abs(x).max()) for x in ge) / 127.0
    mean = (ge[0].astype(np.float64) + ge[1]) / 2
    assert float(np.abs(port[0][f"red_{leaf}"] - mean).max()) <= \
        scale + 1e-6


def test_error_feedback_converges():
    """With error feedback the accumulated compressed gradient tracks
    the true sum (tests/test_training_infra.py's setting)."""
    g = torch.tensor([0.001, -0.0005, 1.0])
    ef = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(200):
        red, ef = PCmp.compressed_allreduce({"g": g}, {"g": ef})
        ef = ef["g"]
        acc = acc + red["g"]
    np.testing.assert_allclose(acc.numpy(), (g * 200).numpy(), rtol=0.02,
                               atol=1e-3)
    # without feedback the small entries vanish every step
    red, _ = PCmp.compressed_allreduce({"g": g}, {"g": torch.zeros(3)})
    assert float(red["g"][1]) == 0.0


def test_zeros_like_error_mirrors_the_tree():
    params = {"w": torch.ones(2, 3, requires_grad=True),
              "b": [torch.ones(4, dtype=torch.float64)]}
    ef = PCmp.zeros_like_error(params)
    assert ef["w"].shape == (2, 3) and not ef["w"].requires_grad
    assert ef["b"][0].dtype == torch.float32 and not ef["b"][0].any()
