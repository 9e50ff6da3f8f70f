"""Ground-truth "hardware": a TPU-v5e-flavored kernel timing simulator.

This container is CPU-only, so real TPU measurement is a hardware gate; per
the task instructions we simulate it. The simulator is the *measurement
oracle* for the whole repo: datasets are labeled with it, the autotuner's
"run on real hardware" steps call it, and the learned model is evaluated
against it.

It deliberately models second-order effects the analytical baseline
(`repro.core.analytical`, mirroring the paper's Appendix A) does not:

* MXU/VPU tile-alignment utilization (multiples of 128 / 8),
* a smooth DMA bandwidth ramp (small transfers get a fraction of peak),
* per-kernel launch overhead and pipeline fill/drain,
* an instruction-scheduling (ILP) factor from graph depth vs. width and a
  register-pressure penalty from fan-out,
* a separate, slower transcendental unit,
* seeded lognormal measurement noise (targets = min of 3 runs, like §4).

Constants match the roofline constants used in EXPERIMENTS.md.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core import opset
from repro_torch.core.graph import KernelGraph


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e-sim"
    peak_mxu_flops: float = 197e12     # bf16; f32 contracts at half rate
    peak_vpu_flops: float = 4.9e12     # 8x128 lanes * ~4.8 GHz-equivalent
    trans_flops: float = 0.6e12        # transcendental unit
    hbm_bw: float = 819e9              # bytes/s
    dma_latency: float = 1.2e-6        # seconds; drives the bandwidth ramp
    vmem_bytes: int = 128 * 1024 * 1024
    vmem_usable_frac: float = 0.75     # compiler reservations
    launch_overhead: float = 2.0e-6    # per-kernel dispatch
    tile_setup: float = 0.15e-6        # per-tile sequencing bubble
    ici_bw: float = 50e9               # per link, used by roofline elsewhere


V5E = HardwareSpec()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // max(b, 1))


def _round_up(a: int, q: int) -> int:
    return _ceil_div(a, q) * q


def _tile_clamped(tile: tuple[int, ...], shape: tuple[int, ...]) -> tuple[int, ...]:
    if not tile:
        tile = shape
    if len(tile) != len(shape):
        # pad/truncate defensively (importer guarantees match normally)
        tile = tuple(tile[:len(shape)]) + shape[len(tile):]
    return tuple(min(max(int(t), 1), int(d)) for t, d in zip(tile, shape))


def default_tile(shape: tuple[int, ...], hw: HardwareSpec = V5E) -> tuple[int, ...]:
    """A plausible compiler-default tile: full shape clipped to ~1/8 VMEM."""
    if not shape:
        return ()
    budget = hw.vmem_bytes * hw.vmem_usable_frac / 8
    tile = [int(d) for d in shape]
    # shrink the major-most dims first, like a row-major tiler would
    i = 0
    def vol(t):
        v = 4
        for x in t:
            v *= x
        return v
    while vol(tile) > budget and i < len(tile):
        while tile[i] > 1 and vol(tile) > budget:
            tile[i] = max(tile[i] // 2, 1)
        i += 1
    return tuple(tile)


@dataclass
class TileStats:
    """Per-tile-iteration statistics shared by simulator & analytical model."""
    num_tiles: int
    tile_frac: float
    bytes_in_per_tile: float
    bytes_out_per_tile: float
    vmem_per_tile: float
    mxu_flops_per_tile: float
    vpu_flops_per_tile: float
    trans_per_tile: float
    tile: tuple[int, ...]


def tile_stats(g: KernelGraph, tile: tuple[int, ...] | None = None,
               hw: HardwareSpec = V5E) -> TileStats:
    root = g.root
    shape = root.shape if root.shape else (1,)
    t = _tile_clamped(tile if tile is not None else g.tile_size, shape)
    num_tiles = 1
    for d, ts in zip(shape, t):
        num_tiles *= _ceil_div(int(d), ts)
    tile_vol = 1
    for ts in t:
        tile_vol *= ts
    root_vol = max(root.volume, 1)
    frac = min(tile_vol / root_vol, 1.0)

    # --- data movement per tile ------------------------------------------
    bytes_in = 0.0
    vmem_in = 0.0
    for p in g.nodes:
        if p.op not in (opset.PARAMETER, opset.CONSTANT):
            continue
        pb = float(p.bytes_out)
        if p.volume >= root_vol:                      # streamed activation
            per = pb * frac
        elif p.volume * 64 >= root_vol:               # sizable weight operand
            per = pb * math.sqrt(frac)                # re-read across tiles
        else:                                         # small constants
            per = pb
        bytes_in += per
        vmem_in += per
    bytes_out = 0.0
    for o in g.output_nodes:
        bytes_out += float(o.bytes_out) * frac
    # intermediates live tile-granular in scratchpad
    vmem_mid = 0.0
    for n in g.nodes:
        if n.op in (opset.PARAMETER, opset.CONSTANT):
            continue
        vmem_mid += float(n.bytes_out) * frac
    vmem = 2.0 * (vmem_in + bytes_out) + vmem_mid     # double buffering

    # --- compute per tile ---------------------------------------------------
    mxu = vpu = trans = 0.0
    for n in g.nodes:
        f = n.flops() * frac
        if n.op.unit == "mxu":
            mxu += f
        elif n.op.unit == "special":
            vpu += f
            trans += n.transcendental_count() * frac
        elif n.op.unit == "vpu":
            vpu += f
    return TileStats(num_tiles=int(num_tiles), tile_frac=frac,
                     bytes_in_per_tile=bytes_in, bytes_out_per_tile=bytes_out,
                     vmem_per_tile=vmem, mxu_flops_per_tile=mxu,
                     vpu_flops_per_tile=vpu, trans_per_tile=trans, tile=t)


def tile_fits_vmem(g: KernelGraph, tile: tuple[int, ...],
                   hw: HardwareSpec = V5E) -> bool:
    st = tile_stats(g, tile, hw)
    return st.vmem_per_tile <= hw.vmem_bytes * hw.vmem_usable_frac


def _util_dim(t: int, q: int) -> float:
    return t / _round_up(max(t, 1), q)


def _mxu_util(tile: tuple[int, ...]) -> float:
    last = tile[-1] if tile else 1
    second = tile[-2] if len(tile) >= 2 else 1
    return _util_dim(last, 128) * _util_dim(second, 8)


def _vpu_util(tile: tuple[int, ...]) -> float:
    last = tile[-1] if tile else 1
    return 0.4 + 0.6 * _util_dim(last, 128)


class TPUSimulator:
    """The 'real hardware'. `measure()` = run on the accelerator."""

    def __init__(self, hw: HardwareSpec = V5E, noise_sigma: float = 0.025,
                 seed: int = 0):
        self.hw = hw
        self.noise_sigma = noise_sigma
        self.seed = seed

    # ------------------------------------------------------------------
    def _ilp_factor(self, g: KernelGraph) -> float:
        n = max(g.num_nodes, 1)
        depth = g.depth()
        serial = 1.0 + 0.18 * max(depth - 1, 0) / n
        fo = g.fan_out()
        max_fo = int(fo.max(initial=0))
        reg = 1.0 + min(0.035 * max(max_fo - 6, 0), 0.5)
        return serial * reg

    def _dma_eff(self, nbytes: float) -> float:
        """Fraction of peak bandwidth achieved for a transfer of nbytes."""
        if nbytes <= 0:
            return 1.0
        ramp = nbytes / (nbytes + self.hw.hbm_bw * self.hw.dma_latency)
        return max(ramp, 0.02)

    def _dtype_rate_scale(self, g: KernelGraph) -> float:
        """f32 contractions run the MXU at half bf16 rate."""
        root = g.root
        for n in g.nodes:
            if n.op.unit == "mxu":
                return 1.0 if n.dtype_bytes <= 2 else 0.5
        return 1.0 if root.dtype_bytes <= 2 else 0.5

    def ideal_time(self, g: KernelGraph, tile: tuple[int, ...] | None = None) -> float:
        """Noise-free modeled runtime in seconds."""
        hw = self.hw
        st = tile_stats(g, tile, hw)
        if st.vmem_per_tile > hw.vmem_bytes * hw.vmem_usable_frac:
            # the compiler would reject this tile; an autotuner that forces it
            # sees a spilled, very slow execution
            spill = st.vmem_per_tile / (hw.vmem_bytes * hw.vmem_usable_frac)
            spill_penalty = 4.0 * spill
        else:
            spill_penalty = 1.0

        mxu_rate = hw.peak_mxu_flops * self._dtype_rate_scale(g)
        mxu_t = st.mxu_flops_per_tile / (mxu_rate * max(_mxu_util(st.tile), 1e-3))
        vpu_t = st.vpu_flops_per_tile / (hw.peak_vpu_flops * _vpu_util(st.tile))
        trans_t = st.trans_per_tile / hw.trans_flops
        compute_t = (mxu_t + vpu_t + trans_t) * self._ilp_factor(g)

        bytes_tile = st.bytes_in_per_tile + st.bytes_out_per_tile
        mem_t = bytes_tile / (hw.hbm_bw * self._dma_eff(bytes_tile))

        steady = max(compute_t, mem_t) + hw.tile_setup
        fill = st.bytes_in_per_tile / (hw.hbm_bw * self._dma_eff(st.bytes_in_per_tile))
        drain = st.bytes_out_per_tile / (hw.hbm_bw * self._dma_eff(st.bytes_out_per_tile))
        total = hw.launch_overhead + fill + drain + st.num_tiles * steady
        return total * spill_penalty

    # ------------------------------------------------------------------
    def _noise(self, g: KernelGraph, tile, run: int) -> float:
        key = f"{g.program}|{g.name}|{tuple(tile) if tile else g.tile_size}|{run}|{self.seed}"
        h = zlib.crc32(key.encode())
        rng = np.random.default_rng(h)
        return float(np.exp(rng.normal(0.0, self.noise_sigma)))

    def measure(self, g: KernelGraph, tile: tuple[int, ...] | None = None,
                runs: int = 3) -> float:
        """Measured runtime: min over `runs` noisy executions (paper §4)."""
        base = self.ideal_time(g, tile)
        return min(base * self._noise(g, tile, r) for r in range(max(runs, 1)))

    def measure_program(self, kernels, runs: int = 3) -> float:
        return float(sum(self.measure(k, runs=runs) for k in kernels))
