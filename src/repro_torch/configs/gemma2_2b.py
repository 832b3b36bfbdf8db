"""gemma2-2b — local+global alternating attention, logit softcaps, sandwich
norms.  [arXiv:2408.00118; hf]  26L d_model=2304 8H (GQA kv=4) head_dim=256
d_ff=9216 vocab=256000, window 4096."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        pattern=("local", "global"),     # sliding first (HF layer 0 = sliding)
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
        sharding_profile="tp",
    )
