"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) vocab=49155,
MoE 40 experts top-8 with d_ff=512 per expert
[hf:ibm-granite family]. (The assignment's structured spec says 40 experts;
its free-text note says 32 — we follow the structured spec.) Full attention
=> long_500k skipped."""
from repro_torch.models.config import ModelConfig, MoEConfig, Stack


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        d_model=1536, vocab_size=49155,
        num_heads=24, num_kv_heads=8, head_dim=64, d_ff=512,
        stacks=(Stack(("attn+moe",), 32),),
        moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
        tie_embeddings=True,
        microbatch=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m-smoke", family="moe",
        d_model=32, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=8, d_ff=32,
        stacks=(Stack(("attn+moe",), 2),),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32),
        tie_embeddings=True,
        microbatch=2, block_kv=16, dtype="float32",
    )
