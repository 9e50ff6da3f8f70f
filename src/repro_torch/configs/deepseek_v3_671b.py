"""deepseek-v3-671b [moe]: 61L d=7168 128H d_ff(expert)=2048 vocab=129280.
MLA (q_lora 1536, kv_lora 512, nope 128 + rope 64, v 128), 1 shared + 256
routed experts top-8 with sigmoid+bias aux-free routing, first 3 layers
dense (d_ff 18432, per the DeepSeek-V3 report; the assignment line only
fixes the expert d_ff=2048) [arXiv:2412.19437].

MTP (multi-token prediction) omitted — it is a training-objective add-on
orthogonal to this paper's runtime-modeling study (noted in DESIGN.md).
Optimizer: Adafactor (factored 2nd moment) — Adam m+v at 671B does not fit
the 256-chip HBM budget; see EXPERIMENTS.md §Dry-run.
Full (latent) attention => long_500k skipped."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig, Stack


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        d_model=7168, vocab_size=129280,
        num_heads=128, d_ff=18432,
        stacks=(
            Stack(("mla+mlp",), 3),
            Stack(("mla+moe",), 58),
        ),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                      num_shared_experts=1, d_ff_shared=2048,
                      router_scale=True),
        optimizer="adafactor",
        # microbatch must be a multiple of the dp axis (16) or the batch
        # replicates per microbatch — found by the §Perf roofline loop
        microbatch=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke", family="moe",
        d_model=64, vocab_size=256,
        num_heads=4, d_ff=128,
        stacks=(
            Stack(("mla+mlp",), 1),
            Stack(("mla+moe",), 1),
        ),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                      num_shared_experts=1, d_ff_shared=32,
                      router_scale=True),
        optimizer="adafactor",
        microbatch=2, block_kv=16, dtype="float32",
    )
