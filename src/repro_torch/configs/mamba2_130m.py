"""mamba2-130m — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]  24L d_model=768 d_ff=0 vocab=50280,
ssm_state=128; d_inner = 2*768 = 1536, head_dim 64 -> 24 SSD heads."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=12,                # unused (no attention layers)
        n_kv_heads=12,
        d_ff=0,                    # mamba block IS the layer (no MLP)
        vocab_size=50280,
        pattern=("ssm",),
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
        conv_kernel=4,
        tie_embeddings=True,
        norm_eps=1e-5,
        ce_chunk=1024,
        sharding_profile="dp",     # 130M params: replicate, shard data
    )
