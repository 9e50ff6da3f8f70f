"""yi-34b [dense]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
llama-arch GQA [arXiv:2403.04652]. Full attention => long_500k skipped.
56 heads on 16-way TP is GSPMD-padded to 64 (see DESIGN.md §6)."""
from repro_torch.models.config import ModelConfig, Stack


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense",
        d_model=7168, vocab_size=64000,
        num_heads=56, num_kv_heads=8, head_dim=128, d_ff=20480,
        stacks=(Stack(("attn+mlp",), 60),),
        rope_theta=5e6,
        microbatch=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke", family="dense",
        d_model=64, vocab_size=256,
        num_heads=6, num_kv_heads=2, head_dim=16, d_ff=128,
        stacks=(Stack(("attn+mlp",), 2),),
        microbatch=2, block_kv=32, dtype="float32",
    )
