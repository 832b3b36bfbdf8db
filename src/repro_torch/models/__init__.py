"""The LM zoo's dense, moe, ssm, hybrid and vlm families (a port of
``repro.models``): config-assembled decoder-only models with GQA or MLA
latent attention, local and global layers, Mamba-2 SSD and RG-LRU
recurrent mixers, dense or mixture-of-experts FFNs, and a stubbed vision
prefix.  The encoder-decoder (ROADMAP item 16d) is not ported yet and
raises, naming its item."""
from repro_torch.models import (  # noqa: F401
    attention,
    common,
    moe,
    registry,
    rglru,
    ssm,
    transformer,
    vlm_stub,
)
