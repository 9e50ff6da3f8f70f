"""qwen3-14b [dense]: 40L d=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
qk-norm on per-head q/k [hf:Qwen/Qwen3-8B]. Full attention => long_500k
skipped."""
from repro_torch.models.config import ModelConfig, Stack


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        d_model=5120, vocab_size=151936,
        num_heads=40, num_kv_heads=8, head_dim=128, d_ff=17408,
        qk_norm=True,
        stacks=(Stack(("attn+mlp",), 40),),
        rope_theta=1e6,
        microbatch=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-smoke", family="dense",
        d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        qk_norm=True,
        stacks=(Stack(("attn+mlp",), 2),),
        microbatch=2, block_kv=32, dtype="float32",
    )
