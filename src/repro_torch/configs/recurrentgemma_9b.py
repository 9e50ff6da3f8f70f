"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (MQA kv=1) d_ff=12288
vocab=256000. RG-LRU + local attention (window 2048) in a 2:1 pattern
[arXiv:2402.19427]. 38 = 12×(lru,lru,attn) + 2×lru. Bounded state + window
=> long_500k applicable."""
from repro_torch.models.config import ModelConfig, RGLRUConfig, Stack


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        d_model=4096, vocab_size=256000,
        num_heads=16, num_kv_heads=1, head_dim=256, d_ff=12288,
        sliding_window=2048,
        stacks=(
            Stack(("rglru+mlp", "rglru+mlp", "swa+mlp"), 12),
            Stack(("rglru+mlp", "rglru+mlp"), 1),
        ),
        rglru=RGLRUConfig(lru_width=4096, conv_width=4, c_exponent=8.0,
                          local_window=2048),
        microbatch=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke", family="hybrid",
        d_model=32, vocab_size=256,
        num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
        sliding_window=16,
        stacks=(
            Stack(("rglru+mlp", "rglru+mlp", "swa+mlp"), 1),
            Stack(("rglru+mlp",), 1),
        ),
        rglru=RGLRUConfig(lru_width=32, conv_width=4),
        microbatch=2, block_kv=16, dtype="float32",
    )
