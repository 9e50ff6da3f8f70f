"""Model-zoo configuration: one dataclass covering all 10 assigned
architectures (dense GQA/SWA transformers, Mamba2 SSD, RG-LRU hybrids,
token-choice MoE, DeepSeek MLA+MoE, audio/VLM backbones).

A copy of the JAX package's `models/config.py` (it imports no jax), so
that configs compare field by field across the two packages. A model is
a sequence of *stacks*; each stack is a layer pattern repeated N times
(the reference scans it with `jax.lax.scan`; the port loops over the
layers). Pattern elements are "<mixer>+<ffn>" strings:

  mixers: attn | swa | mla | ssd | rglru      ffns: mlp | moe | none
"""
from __future__ import annotations

from dataclasses import dataclass, asdict


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_scale: bool = False            # deepseek sigmoid+bias routing


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    ngroups: int = 1


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0                    # 0 => d_model
    conv_width: int = 4
    c_exponent: float = 8.0
    local_window: int = 2048


@dataclass(frozen=True)
class Stack:
    pattern: tuple[str, ...]              # e.g. ("rglru+mlp","rglru+mlp","swa+mlp")
    repeats: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                           # dense | ssm | hybrid | moe | audio | vlm
    d_model: int
    vocab_size: int
    stacks: tuple[Stack, ...]
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                     # 0 => d_model // num_heads
    d_ff: int = 0
    sliding_window: int = 4096            # used by 'swa' mixers
    qk_norm: bool = False
    attn_pad_heads: int = 0               # pad q-heads to this count with
    #   zero-init wo rows (exact at init) so heads shard cleanly over TP —
    #   avoids the head-dim-TP fallback that psums attention scores
    #   (§Perf lever; MaxText-style padding)
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # sub-configs
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    # modality frontend stub: inputs are precomputed embeddings
    embed_inputs: bool = False            # musicgen (frame embeddings)
    num_patch_tokens: int = 0             # llava (patch embeddings prefix)
    # numerics / training
    dtype: str = "bfloat16"
    remat: str = "full"                   # none | full | dots
    block_kv: int = 512                   # chunked-attention KV block
    use_pallas_attn: bool = False         # the flash-attention kernel: in
    #   the port, the hand-written CUDA kernel (kernels/flash_attention.py);
    #   the name stays the reference's so that configs compare field by field
    microbatch: int = 16                  # grad-accumulation microbatch size
    optimizer: str = "adamw"              # adamw | adafactor
    grad_accum: str = "scan_of_grads"     # scan_of_grads | grad_of_scan —
    #   grad_of_scan differentiates the whole microbatch loop at once, so
    #   the cross-replica gradient reduction happens ONCE per step instead
    #   of once per microbatch (§Perf lever; collective bytes ÷ n_micro)
    grad_accum_dtype: str = "float32"     # float32 | bfloat16 accumulator
    # sharding
    fsdp: bool = True                     # shard params/opt over data axis
    seq_shard_decode: bool = True         # long-context: shard cache seq
    embed_shard: str = "vocab"            # vocab | dmodel — embedding table
    #   TP axis; "dmodel" avoids GSPMD's involuntary full remat on the
    #   vocab-sharded gather (a §Perf lever)
    # roofline probes: python-unroll the layer / microbatch loops so
    # cost_analysis counts every iteration (scan bodies are counted once)
    scan_layers: bool = True
    scan_microbatch: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def num_layers(self) -> int:
        return sum(len(s.pattern) * s.repeats for s in self.stacks)

    def layer_types(self) -> list[str]:
        out = []
        for s in self.stacks:
            for _ in range(s.repeats):
                out.extend(s.pattern)
        return out

    def has_mixer(self, kind: str) -> bool:
        return any(p.split("+")[0] == kind for p in self.layer_types())

    @property
    def subquadratic(self) -> bool:
        """True if decode memory is bounded (no unbounded full-attn cache)."""
        return not self.has_mixer("attn") and not self.has_mixer("mla")

    def to_dict(self) -> dict:
        return asdict(self)


# ----------------------------------------------------------------------------
# Assigned input-shape grid
# ----------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                             # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# smoke-test (reduced) shape used by per-arch CI tests
SMOKE_SHAPE = ShapeSpec("smoke", 64, 2, "train")


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k only runs for sub-quadratic archs (assignment rule)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (f"{cfg.name} uses unbounded full attention; 500k-token "
                       "decode is skipped per assignment (see DESIGN.md)")
    return True, ""
