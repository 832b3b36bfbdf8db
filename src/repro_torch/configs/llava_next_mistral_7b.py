"""llava-next-mistral-7b — mistral-7b text backbone; the anyres vision tower
is a STUB (input_specs supplies 2880 = 5 tiles x 576 precomputed patch
embeddings prepended to the text).  [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        pattern=("global",),
        vision_tokens=2880,         # anyres: 5 tiles x 24x24 patches
        act="silu",
        rope_theta=1000000.0,
        tie_embeddings=False,
        norm_eps=1e-5,
        train_microbatches=8,
        ce_chunk=1024,
        sharding_profile="fsdp_tp",
    )
