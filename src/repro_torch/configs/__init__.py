"""Exact configs for the zoo's 10 LM architectures (a port of
``repro.configs``).  Each module exposes ``config() -> ModelConfig``;
``REGISTRY`` maps --arch ids to them.  All ten are here as data; the
families the port cannot run yet raise when a task or model is built."""
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    gemma2_2b,
    gemma2_9b,
    llava_next_mistral_7b,
    mamba2_130m,
    qwen2_moe_a27b,
    qwen3_4b,
    recurrentgemma_9b,
    smollm_135m,
    whisper_base,
)

REGISTRY = {
    "mamba2-130m": mamba2_130m.config,
    "gemma2-2b": gemma2_2b.config,
    "gemma2-9b": gemma2_9b.config,
    "smollm-135m": smollm_135m.config,
    "qwen3-4b": qwen3_4b.config,
    "deepseek-v2-236b": deepseek_v2_236b.config,
    "qwen2-moe-a2.7b": qwen2_moe_a27b.config,
    "whisper-base": whisper_base.config,
    "llava-next-mistral-7b": llava_next_mistral_7b.config,
    "recurrentgemma-9b": recurrentgemma_9b.config,
}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch: str, reduced: bool = False):
    cfg = REGISTRY[arch]()
    return cfg.reduced() if reduced else cfg
