"""musicgen-large [audio]: 48L d=2048 32H (kv=32) d_ff=8192 vocab=2048.
Decoder-only transformer over EnCodec tokens [arXiv:2306.05284]. Per the
assignment, the EnCodec frontend is a STUB: input_specs() provides
precomputed frame embeddings [B,S,d_model] for train/prefill; decode
consumes codebook token ids. Full attention => long_500k skipped."""
from repro_torch.models.config import ModelConfig, Stack


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        d_model=2048, vocab_size=2048,
        num_heads=32, num_kv_heads=32, d_ff=8192,
        stacks=(Stack(("attn+mlp",), 48),),
        embed_inputs=True,
        microbatch=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke", family="audio",
        d_model=64, vocab_size=64,
        num_heads=4, num_kv_heads=4, d_ff=128,
        stacks=(Stack(("attn+mlp",), 2),),
        embed_inputs=True,
        microbatch=2, block_kv=32, dtype="float32",
    )
