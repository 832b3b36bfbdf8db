"""The LM zoo (a port of ``repro.models``): config-assembled decoder-only
models of the dense, moe, ssm, hybrid and vlm families, with GQA or MLA
latent attention, local and global layers, Mamba-2 SSD and RG-LRU
recurrent mixers, dense or mixture-of-experts FFNs and a stubbed vision
prefix, and the audio family's encoder-decoder (whisper, its conv
frontend a stub)."""
from repro_torch.models import (  # noqa: F401
    attention,
    common,
    encdec,
    moe,
    registry,
    rglru,
    ssm,
    transformer,
    vlm_stub,
)
