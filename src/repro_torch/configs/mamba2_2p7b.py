"""mamba2-2.7b [ssm]: 64L d=2560, attention-free, vocab 50280, ssm_state=128.
SSD (state-space duality) [arXiv:2405.21060]. Constant-memory decode state
=> long_500k applicable."""
from repro_torch.models.config import ModelConfig, SSMConfig, Stack


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        d_model=2560, vocab_size=50280,
        d_ff=0,
        stacks=(Stack(("ssd",), 64),),
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                      chunk=256),
        tie_embeddings=True,
        microbatch=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke", family="ssm",
        d_model=32, vocab_size=256,
        d_ff=0,
        stacks=(Stack(("ssd",), 2),),
        ssm=SSMConfig(d_state=16, head_dim=8, expand=2, conv_width=4,
                      chunk=16),
        tie_embeddings=True,
        microbatch=2, dtype="float32",
    )
