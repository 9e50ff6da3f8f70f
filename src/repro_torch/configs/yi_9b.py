"""yi-9b [dense]: 48L d=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
llama-arch GQA [arXiv:2403.04652]. Full attention => long_500k skipped."""
from repro_torch.models.config import ModelConfig, Stack


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b", family="dense",
        d_model=4096, vocab_size=64000,
        num_heads=32, num_kv_heads=4, d_ff=11008,
        stacks=(Stack(("attn+mlp",), 48),),
        rope_theta=5e6,
        microbatch=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b-smoke", family="dense",
        d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, d_ff=128,
        stacks=(Stack(("attn+mlp",), 2),),
        microbatch=2, block_kv=32, dtype="float32",
    )
