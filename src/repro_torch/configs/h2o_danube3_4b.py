"""h2o-danube-3-4b [dense]: 24L d=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
llama+mistral mix with sliding-window attention (window 4096)
[arXiv:2401.16818]. SWA => bounded decode cache => long_500k applicable."""
from repro_torch.models.config import ModelConfig, Stack


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense",
        d_model=3840, vocab_size=32000,
        num_heads=32, num_kv_heads=8, d_ff=10240,
        sliding_window=4096,
        stacks=(Stack(("swa+mlp",), 24),),
        rope_theta=1e4,
        microbatch=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-smoke", family="dense",
        d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, d_ff=128,
        sliding_window=16,
        stacks=(Stack(("swa+mlp",), 2),),
        microbatch=2, block_kv=32, dtype="float32",
    )
