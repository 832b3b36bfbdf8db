"""qwen3-4b — GQA with per-head qk-norm.  [hf:Qwen/Qwen3-8B family; hf]
36L d_model=2560 32H (GQA kv=8) head_dim=128 d_ff=9728 vocab=151936."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151936,
        pattern=("global",),
        qk_norm=True,
        act="silu",
        rope_theta=1000000.0,
        tie_embeddings=True,
        train_microbatches=4,
        ce_chunk=512,
        sharding_profile="tp",
    )
