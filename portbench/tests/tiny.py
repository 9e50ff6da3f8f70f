"""Tiny configurations and a tiny benchmark root for the CPU tests.

The configurations are the program's smoke sizes (`smoke_config()` of
`repro_torch.configs.granite_moe_3b` and `deepseek_v3_671b`) written as
the benchmark's configuration files: published-style keys with the
published values, `departures` with what the program runs in their
place, `port` for the program. `root(tmp, dtype)` copies the
benchmark into `tmp` with a `BENCHMARK.json` of tiny cells, one per
traffic driver and configuration, holding the real cells' limits.
"""
from __future__ import annotations

import copy
import json
import math
import os
import shutil

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)

GRANITE = {
    "hidden_size": 32, "num_attention_heads": 4, "num_key_value_heads": 2,
    "num_hidden_layers": 2, "num_local_experts": 8, "num_experts_per_tok": 2,
    "intermediate_size": 32, "vocab_size": 256, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "embedding_multiplier": 12.0,
    "attention_multiplier": 0.015625, "residual_multiplier": 0.22,
    "logits_scaling": 6.0,
    "departures": {"embedding_multiplier": {"runs": math.sqrt(32)},
                   "attention_multiplier": {"runs": 1 / math.sqrt(8)},
                   "residual_multiplier": {"runs": 1.0},
                   "logits_scaling": {"runs": 1.0},
                   "capacity_factor": {"runs": 1.25}},
    "port": {"name": "granite-tiny", "family": "moe", "d_model": 32,
             "vocab_size": 256, "num_heads": 4, "num_kv_heads": 2,
             "head_dim": 8, "d_ff": 32, "stacks": [[["attn+moe"], 2]],
             "moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 32,
                     "capacity_factor": 1.25},
             "tie_embeddings": True, "use_pallas_attn": True,
             "block_kv": 16, "dtype": "float32"},
    "init": {"std": 0.02, "ones": ["scale"], "zeros": ["e_bias"]},
}

DEEPSEEK = {
    "hidden_size": 64, "num_attention_heads": 4, "q_lora_rank": 32,
    "kv_lora_rank": 16, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "num_hidden_layers": 2, "first_k_dense_replace": 1,
    "intermediate_size": 128, "n_routed_experts": 8, "n_shared_experts": 1,
    "num_experts_per_tok": 2, "moe_intermediate_size": 32,
    "vocab_size": 256, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "scoring_func": "sigmoid", "norm_topk_prob": True, "n_group": 4,
    "topk_group": 2, "routed_scaling_factor": 2.5,
    "rope_scaling": {"type": "yarn", "factor": 40},
    "departures": {"topk_group": {"runs": 4},
                   "routed_scaling_factor": {"runs": 1.0},
                   "rope_scaling": {"runs": None},
                   "embedding_multiplier": {"runs": 8.0},
                   "capacity_factor": {"runs": 1.25}},
    "port": {"name": "deepseek-tiny", "family": "moe", "d_model": 64,
             "vocab_size": 256, "num_heads": 4, "d_ff": 128,
             "stacks": [[["mla+mlp"], 1], [["mla+moe"], 1]],
             "mla": {"q_lora_rank": 32, "kv_lora_rank": 16,
                     "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                     "v_head_dim": 16},
             "moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 32,
                     "num_shared_experts": 1, "d_ff_shared": 32,
                     "router_scale": True, "capacity_factor": 1.25},
             "block_kv": 16, "dtype": "float32"},
    "init": {"std": 0.02, "ones": ["scale"], "zeros": ["e_bias"]},
}

CONFIGS = {"granite-moe-3b-a800m": GRANITE, "deepseek-v3-671b": DEEPSEEK}

# mamba2-2.7b's smoke size (`repro_torch.configs.mamba2_2p7b`), with
# state-spaces' published keys: a kind of model that no cell runs yet,
# for the test that finds a new configuration by name
MAMBA2 = {
    "d_model": 32, "n_layer": 2, "vocab_size": 256, "d_state": 16,
    "d_conv": 4, "expand": 2, "headdim": 8, "ngroups": 1, "chunk_size": 16,
    "norm_epsilon": 1e-5, "tie_embeddings": True,
    "departures": {"embedding_multiplier": {"runs": math.sqrt(32)}},
    "port": {"name": "mamba2-tiny", "family": "ssm", "d_model": 32,
             "vocab_size": 256, "d_ff": 0, "stacks": [[["ssd"], 2]],
             "ssm": {"d_state": 16, "head_dim": 8, "expand": 2,
                     "conv_width": 4, "chunk": 16},
             "tie_embeddings": True, "norm_eps": 1e-5, "dtype": "float32"},
    "init": {"std": 0.02, "ones": ["scale", "D_skip"],
             "zeros": ["conv_b", "A_log"]},
}

TRAFFIC = {
    "tiny.prefill": {"driver": "prefill", "batch": 2, "prompt_len": 32,
                     "trace_calls": 1},
    "tiny.decode": {"driver": "decode", "batch": 4, "prompt_len": 16,
                    "decode_tokens": 8, "check_sequences": 2,
                    "trace_steps": 2},
}

# tiny cell -> (configuration, traffic, the real cell whose limits it holds)
CELLS = {
    "tiny.granite.prefill": ("granite-moe-3b-a800m", "tiny.prefill",
                             "granite-moe.prefill-4k"),
    "tiny.deepseek.prefill": ("deepseek-v3-671b", "tiny.prefill",
                              "deepseek-v3.prefill-8k"),
    "tiny.deepseek.decode": ("deepseek-v3-671b", "tiny.decode",
                             "deepseek-v3.decode-b32"),
}


def config(name: str, dtype: str = "float32") -> dict:
    c = copy.deepcopy(CONFIGS[name])
    c["port"]["dtype"] = dtype
    return c


def root(tmp: str, dtype: str = "bfloat16") -> str:
    """A benchmark root in `tmp`: the repo's `portbench/` and program, and
    a BENCHMARK.json of the tiny cells. Returns its path."""
    r = os.path.join(str(tmp), "root")
    shutil.copytree(PB, os.path.join(r, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    os.symlink(os.path.join(REPO, "src"), os.path.join(r, "src"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = os.path.join(r, "portbench")
    for name in CONFIGS:
        with open(os.path.join(pb, "configs", f"tiny-{name}.json"), "w") as f:
            json.dump(config(name, dtype), f)
    for name, t in TRAFFIC.items():
        with open(os.path.join(pb, "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)
    bench["configs"] = [{"name": n, "source": "tiny", "reduced": [],
                         "file": f"portbench/configs/tiny-{n}.json",
                         "why": "tiny"} for n in CONFIGS]
    bench["workloads"] = []
    for cell, (conf, traf, real) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": traf, "chips": 1,
                                   "why": "tiny"})
        shutil.copy(os.path.join(pb, "workloads", f"{real}.json"),
                    os.path.join(pb, "workloads", f"{cell}.json"))
        for m in bench["per_layer"] + bench["end_to_end"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    with open(os.path.join(r, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return r
