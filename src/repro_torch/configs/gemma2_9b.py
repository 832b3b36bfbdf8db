"""gemma2-9b — local+global alternating attention, logit softcaps, sandwich
norms.  [arXiv:2408.00118; hf]  42L d_model=3584 16H (GQA kv=8) head_dim=256
d_ff=14336 vocab=256000, window 4096."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        pattern=("local", "global"),
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norms=True,
        embed_scale=True,
        act="gelu",
        rope_theta=10000.0,
        tie_embeddings=True,
        train_microbatches=4,
        ce_chunk=256,
        sharding_profile="fsdp_tp",
    )
