"""The LM zoo's dense, moe and vlm families (a port of ``repro.models``):
config-assembled decoder-only models with GQA or MLA latent attention,
local and global layers, dense or mixture-of-experts FFNs, and a stubbed
vision prefix.  The SSM and RG-LRU mixers (ROADMAP item 16c) and the
encoder-decoder (16d) are not ported yet and raise, naming their item."""
from repro_torch.models import (  # noqa: F401
    attention,
    common,
    moe,
    registry,
    transformer,
    vlm_stub,
)
