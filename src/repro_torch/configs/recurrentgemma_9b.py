"""recurrentgemma-9b — Griffin: RG-LRU recurrent blocks + local attention,
1 attn per 2 recurrent.  [arXiv:2402.19427; unverified]
38L d_model=4096 16H (MQA kv=1) head_dim=256 d_ff=12288 vocab=256000,
window 2048, lru_width 4096."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,                # 12 x (rec, rec, local) + (rec, rec)
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        pattern=("rec", "rec", "local"),
        window=2048,
        rglru_width=4096,
        conv_kernel=4,
        embed_scale=True,
        act="gelu",
        rope_theta=10000.0,
        tie_embeddings=True,
        train_microbatches=8,
        ce_chunk=256,
        sharding_profile="fsdp_tp",
    )
