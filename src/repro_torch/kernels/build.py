"""Builds the port's hand-written CUDA kernels and loads them with ctypes.

Each source `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). Libraries land in `kernels/build/` (git-ignored)
under a name that carries a digest of the sources and flags, so an edited
source never loads a stale build. `build()` starts one `nvcc` per missing
library, all at once; `load()` builds on first use. Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
SOURCES = ("graph_aggregate", "segment_aggregate", "flash_attention_tf32",
           "flash_attention_sm90", "flash_attention_hd256",
           "flash_attention_hd256_tf32", "ssd_scan", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_HEADERS = ("tf32_mma.cuh", "flash_tf32.cuh", "wgmma_bf16.cuh")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: `$CUDA_HOME/bin/nvcc`, else the one on
    PATH, else the toolkit's default prefix. Raises if there is none."""
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + _HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names=SOURCES) -> dict[str, str]:
    """Compile each named source whose library is missing, one `nvcc`
    per source, all started together. Returns `{name: ptxas report}` for
    what was compiled (registers, shared memory, spills per kernel).
    Raises RuntimeError with the compiler's output on any failure."""
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n in todo:
        tmp = f"{library_path(n)}.{os.getpid()}.tmp"
        cmd = [exe, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    reports, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}.cu (exit {p.returncode}):\n{out}")
            continue
        os.replace(tmp, library_path(n))
        reports[n] = out
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def check_one_device(kernel: str, **tensors) -> None:
    """Raises a ValueError that names the devices when `tensors` lie on
    more than one. Each wrapper launches its kernel inside
    `torch.cuda.device(...)` of that one device, so that the kernel runs
    on its tensors' card whatever the current device is."""
    devices = {name: t.device for name, t in tensors.items()}
    if len(set(devices.values())) > 1:
        raise ValueError(f"{kernel}: tensors on more than one device: "
                         + ", ".join(f"{name} on {dev}"
                                     for name, dev in devices.items()))


def check_no_grad(kernel: str, flag: str | None = None, **tensors) -> None:
    """Raises a RuntimeError when grad mode is on and one of `tensors`
    requires grad. The kernels have no backward (nor have the TPU
    kernels they replace): their outputs carry no `grad_fn`, so inside a
    differentiated forward every parameter upstream of them would get no
    gradient, silently. Every wrapper calls it on both routes, so that a
    forward behaves alike on the CPU and on the card. `flag` names the
    model option that routes through the kernel, for the message."""
    if not torch.is_grad_enabled():
        return
    needs = [name for name, t in tensors.items() if t.requires_grad]
    if needs:
        fix = f"train with {flag}=False, or run" if flag else "run"
        raise RuntimeError(
            f"{kernel} has no backward, but {', '.join(needs)} require(s) "
            f"grad: {fix} the forward under torch.no_grad() / "
            "torch.inference_mode()")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
        return lib
