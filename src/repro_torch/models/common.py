"""Shared building blocks of the LM zoo: the ModelConfig schema, norms,
rotary embeddings, MLPs, embeddings, initializers, and the causal conv and
linear-recurrence scan of the SSM and RG-LRU layers.

A port of ``repro.models.common``.  Parameters live in ``nn.Module``s
(``nn.ParameterDict`` for a layer's weights, keyed by the reference's
names) in ``cfg.param_dtype``; the apply functions are plain functions on
tensors that cast each weight to ``cfg.dtype`` where they use it, as the
reference does.  An initializer given ``generator=None`` allocates its
tensors uninitialised, for a caller that loads them
(``convert.lm_params_from_reference``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One schema covers the whole zoo; families toggle feature flags.
    Exact per-arch values live in src/repro_torch/configs/<id>.py."""

    name: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // n_heads

    # layer pattern: tuple of kinds repeated down the stack.
    # kinds: 'global' | 'local' (sliding-window attn) | 'ssm' | 'rec' (RG-LRU)
    pattern: Tuple[str, ...] = ("global",)

    # attention options
    window: int = 4096                # local attention window
    qk_norm: bool = False             # qwen3
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    rope_theta: float = 10000.0
    post_norms: bool = False          # gemma2 sandwich norms
    embed_scale: bool = False         # gemma family: x *= sqrt(d)

    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    mla_absorb: bool = False          # absorbed-matrix decode (perf variant)

    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0            # deepseek-v2: first layer stays dense
    capacity_factor: float = 1.25
    routed_scaling: float = 1.0
    norm_topk_prob: bool = False

    # SSM (mamba2 / SSD)
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_kernel: int = 4

    # RG-LRU (recurrentgemma)
    rglru_width: int = 0              # 0 => d_model
    rglru_c: float = 8.0
    rglru_blocks: int = 16            # block-diagonal gate weights

    # encoder-decoder (whisper)
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    decoder_len: int = 448            # target length used by train shapes

    # vlm (llava)
    vision_tokens: int = 0            # prepended patch-embedding tokens

    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"
    dtype: Any = torch.bfloat16       # activation/compute dtype
    param_dtype: Any = torch.float32

    # parallel/runtime policy (read by training and the mesh, items 16e/16f)
    sharding_profile: str = "dp"      # dp | tp | fsdp_tp
    remat: bool = True
    scan_layers: bool = True
    ce_chunk: int = 2048              # chunked cross-entropy block (tokens)
    train_microbatches: int = 1
    optimizer: str = "adamw"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_rnn(self) -> int:
        return self.rglru_width or self.d_model

    @property
    def segments(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """(pattern, repeats) segments covering n_layers; a trailing partial
        repetition becomes its own segment (e.g. recurrentgemma 38 = 12x
        (rec,rec,global-local…) + the remainder)."""
        p = len(self.pattern)
        reps, rem = divmod(self.n_layers, p)
        segs = []
        if self.first_k_dense:
            segs.append(((self.pattern[0] + ":dense",), self.first_k_dense))
            # recompute repetitions over the remaining layers
            reps, rem = divmod(self.n_layers - self.first_k_dense, p)
        if reps:
            segs.append((self.pattern, reps))
        if rem:
            segs.append((self.pattern[:rem], 1))
        return tuple(segs)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """The kind of every layer, bottom up: segment ``s``'s pattern entry
        ``i`` at repeat ``rep`` is layer ``offset_s + rep * len(pattern) +
        i``, ``offset_s`` the layers of the earlier segments."""
        return tuple(kind for pattern, reps in self.segments
                     for _ in range(reps) for kind in pattern)

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU smoke tests."""
        small = dict(
            n_layers=len(self.pattern) * 2 if len(self.pattern) > 1 else 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            window=16,
            kv_lora_rank=32,
            q_lora_rank=48 if self.q_lora_rank else None,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
            n_experts=8 if self.moe else 0,
            n_shared_experts=min(self.n_shared_experts, 2),
            top_k=min(self.top_k, 2) if self.moe else 0,
            moe_d_ff=32 if self.moe else 0,
            # dropless (cf = E/K) so prefill/decode/teacher-forced paths are
            # bit-equivalent in the consistency tests
            capacity_factor=4.0,
            first_k_dense=min(self.first_k_dense, 1),
            ssm_state=16,
            ssm_head_dim=8,
            ssm_chunk=8,
            rglru_width=32 if self.rglru_width else 0,
            n_encoder_layers=2 if self.encoder_decoder else 0,
            decoder_len=16,
            vision_tokens=8 if self.vision_tokens else 0,
            dtype=torch.float32,
            sharding_profile="dp",
            ce_chunk=64,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _param(t: torch.Tensor) -> nn.Parameter:
    # serving takes no gradient; LM training asks for one where it takes
    # it (``train/loop.value_and_grad``)
    return nn.Parameter(t, requires_grad=False)


def dense_init(generator, shape, in_axis_size, dtype, device=None):
    """Truncated-normal fan-in init (the zoo's shared default): a standard
    normal truncated to [-2, 2], times ``1/sqrt(in_axis_size)``."""
    device = generator.device if device is None else device
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if generator is not None:
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(1.0 / math.sqrt(in_axis_size))
    return _param(t.to(dtype))


def embed_init(generator, shape, dtype, device=None):
    device = generator.device if device is None else device
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if generator is not None:
        t.normal_(generator=generator).mul_(0.02)
    return _param(t.to(dtype))


def zeros_init(shape, dtype, device):
    return _param(torch.zeros(shape, dtype=dtype, device=device))


def ones_init(shape, dtype, device):
    return _param(torch.ones(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _gelu_tanh(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# Causal convolution and linear recurrences (the SSM and RG-LRU layers)
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d without bias: x (B, L, C), w (K, C); the K
    shifted products summed in order, in x's dtype (the reference's
    ``sum`` over shifts)."""
    K, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:L] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + L] * w[i]
    return out


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1):
    """The inclusive scan of ``h_t = a_t · h_{t-1} + b_t`` along ``dim``:
    ``(aa, bb)`` with ``aa_t = a_1 ⋯ a_t`` and ``bb_t`` the state at ``t``
    from a zero start, so the state from ``h_0`` is ``aa_t · h_0 + bb_t``.
    The pairs combine as ``jax.lax.associative_scan``'s do in the
    reference's SSD and RG-LRU layers, ``(al·ar, bl·ar + br)``, but in a
    log-depth doubling (Hillis–Steele) order: ⌈log₂ L⌉ rounds, each one
    shifted multiply-add over the whole tensor, so the sums round in
    another order than XLA's.  ``a`` broadcasts against ``b`` (same
    rank; trailing axes of size 1 allowed)."""
    L = b.shape[dim]
    shift = 1
    while shift < L:
        n = L - shift
        a_cur, b_cur = a.narrow(dim, shift, n), b.narrow(dim, shift, n)
        b = torch.cat([b.narrow(dim, 0, shift),
                       b.narrow(dim, 0, n) * a_cur + b_cur], dim)
        a = torch.cat([a.narrow(dim, 0, shift),
                       a.narrow(dim, 0, n) * a_cur], dim)
        shift *= 2
    return a, b


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., L, H, hd) or (..., L, hd); positions: (..., L).  Rotates
    the head's two halves (not interleaved pairs), in fp32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs              # (..., L, half)
    if x.dim() == ang.dim() + 1:                            # head axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (L, d)."""
    return sinusoidal_at(
        torch.arange(length, dtype=torch.float32, device=device), dim)


def sinusoidal_at(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embeddings evaluated at arbitrary positions: (..., L) ->
    (..., L, dim).  No table, so decode positions can exceed any pre-built
    length."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (gated / plain)
# ---------------------------------------------------------------------------

def init_mlp(generator, d_model: int, d_ff: int, cfg: ModelConfig,
             gated: bool = True, device=None) -> nn.ParameterDict:
    pd = cfg.param_dtype
    p = nn.ParameterDict({
        "wi": dense_init(generator, (d_model, d_ff), d_model, pd, device),
        "wo": dense_init(generator, (d_ff, d_model), d_ff, pd, device),
    })
    if gated:
        p["wg"] = dense_init(generator, (d_model, d_ff), d_model, pd, device)
    return p


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = act_fn(cfg.act)
    up = torch.einsum("...d,df->...f", x, p["wi"].to(cfg.dtype))
    if "wg" in p:
        up = act(torch.einsum("...d,df->...f", x, p["wg"].to(cfg.dtype))) * up
    else:
        up = act(up)
    return torch.einsum("...f,fd->...d", up, p["wo"].to(cfg.dtype))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(generator, cfg: ModelConfig, device=None) -> nn.ParameterDict:
    p = nn.ParameterDict({"table": embed_init(
        generator, (cfg.vocab_size, cfg.d_model), cfg.param_dtype, device)})
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                  cfg.d_model, cfg.param_dtype, device)
    return p


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # rows gathered, then cast: the reference casts the whole table first,
    # which gives the same values
    x = p["table"][tokens.long()].to(cfg.dtype)
    if cfg.embed_scale:
        # sqrt(d) rounded to cfg.dtype first (bf16: sqrt(3584) -> 59.75)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype,
                             device=x.device)
    return x


def unembed(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """hidden (..., d) -> logits (..., V) fp32, final softcap applied."""
    if cfg.tie_embeddings:
        logits = torch.einsum("...d,vd->...v", x.float(), p["table"].float())
    else:
        logits = torch.einsum("...d,dv->...v", x.float(),
                              p["unembed"].float())
    return softcap(logits, cfg.final_softcap)
