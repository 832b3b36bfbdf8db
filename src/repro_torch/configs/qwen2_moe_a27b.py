"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (kv=16) head_dim=128
moe_d_ff=1408 vocab=151936 (shared expert = 4*1408 = 5632)."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=0,                     # every layer is MoE
        vocab_size=151936,
        pattern=("global",),
        moe=True,
        n_experts=60,
        n_shared_experts=4,
        top_k=4,
        moe_d_ff=1408,
        norm_topk_prob=False,
        act="silu",
        rope_theta=1000000.0,
        tie_embeddings=False,
        train_microbatches=4,
        ce_chunk=512,
        sharding_profile="fsdp_tp",
    )
