"""whisper-base — encoder-decoder; conv frontend is a STUB (input_specs
supplies post-conv frame embeddings).  [arXiv:2212.04356; unverified]
6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865, LayerNorm + GELU."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,                 # decoder layers
        n_encoder_layers=6,
        encoder_decoder=True,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51865,
        decoder_len=448,
        pattern=("global",),
        act="gelu",
        tie_embeddings=True,
        norm_eps=1e-5,
        train_microbatches=2,
        sharding_profile="dp",
    )
