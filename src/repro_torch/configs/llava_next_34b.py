"""llava-next-34b [vlm]: yi-34b backbone (60L d=7168 56H GQA kv=8
d_ff=20480 vocab=64000) with anyres image tiling
[hf:llava-hf/llava-v1.6 family]. Per the assignment, the vision tower +
anyres projector are a STUB: input_specs() provides precomputed patch
embeddings [B, 1152, d_model] prefixed to the text tokens (1152 = 2 anyres
tiles × 576 patches). Full attention => long_500k skipped."""
from repro_torch.models.config import ModelConfig, Stack

NUM_PATCH_TOKENS = 1152


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        d_model=7168, vocab_size=64000,
        num_heads=56, num_kv_heads=8, head_dim=128, d_ff=20480,
        stacks=(Stack(("attn+mlp",), 60),),
        num_patch_tokens=NUM_PATCH_TOKENS,
        rope_theta=5e6,
        microbatch=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b-smoke", family="vlm",
        d_model=64, vocab_size=256,
        num_heads=6, num_kv_heads=2, head_dim=16, d_ff=128,
        stacks=(Stack(("attn+mlp",), 2),),
        num_patch_tokens=16,
        microbatch=2, block_kv=32, dtype="float32",
    )
