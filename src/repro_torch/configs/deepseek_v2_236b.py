"""deepseek-v2-236b — MLA latent attention (kv_lora=512) + fine-grained MoE
(2 shared + 160 routed, top-6).  [arXiv:2405.04434; hf]
60L d_model=5120 128H vocab=102400, moe_d_ff=1536, first layer dense
(d_ff=12288), routed_scaling=16."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,                 # the first (dense) layer's FFN
        vocab_size=102400,
        pattern=("global",),
        use_mla=True,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        moe=True,
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1536,
        first_k_dense=1,
        routed_scaling=16.0,
        norm_topk_prob=False,
        act="silu",
        rope_theta=10000.0,
        tie_embeddings=False,
        train_microbatches=16,
        optimizer="adafactor",
        ce_chunk=512,
        sharding_profile="fsdp_tp",
    )
