"""The LM zoo's dense and vlm families (a port of ``repro.models``):
config-assembled decoder-only models with GQA attention, local and global
layers, and a stubbed vision prefix.  MoE and MLA (ROADMAP item 16b), the
SSM and RG-LRU mixers (16c) and the encoder-decoder (16d) are not ported
yet and raise, naming their item."""
from repro_torch.models import (  # noqa: F401
    attention,
    common,
    registry,
    transformer,
    vlm_stub,
)
