"""The port's LM layers (``repro_torch.models.common`` and ``attention``)
against the reference's on the same numpy inputs, fp32, rtol/atol 1e-5:
norms, activations (gelu is the tanh approximation), rope, sinusoids, the
MLP, embedding and unembedding, the linear-recurrence scan of the SSM and
RG-LRU layers (``tests/test_torch_lm_recurrent.py`` holds the layers);
masks, dense attention, the flash path
with shrunk blocks against both packages' dense paths, and
``apply_attention`` without a cache, at prefill, at decode, on a local
ring, with qk-norm and with cross-attention memory, and MLA through it
(``tests/test_torch_lm_moe.py`` holds MLA's paths one by one)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro_torch.models import attention as port_attn
from repro_torch.models import common as port_common

TOL = dict(rtol=1e-5, atol=1e-5)
# one compile a shape instead of one a primitive: eager JAX is slow here
ref_apply_attention = jax.jit(ref_attn.apply_attention,
                              static_argnames=("cfg", "kind", "causal"))


def rng(seed=0):
    return np.random.default_rng(seed)


def normal(r, *shape):
    return r.normal(size=shape).astype(np.float32)


def cfgs(**kw):
    """The same small config in both packages, fp32 activations."""
    base = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, head_dim=8, d_ff=48, vocab_size=64)
    base.update(kw)
    return (ref_common.ModelConfig(dtype=jnp.float32, **base),
            port_common.ModelConfig(dtype=torch.float32, **base))


def close(got, want, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def to_port(p):
    return torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(np.array(v, np.float32)),
                               requires_grad=False) for k, v in p.items()})


# ---------------------------------------------------------------------------
# common.py
# ---------------------------------------------------------------------------

def test_norms_and_softcap():
    r = rng(1)
    x, s, b = normal(r, 3, 5, 16) * 3, normal(r, 16), normal(r, 16)
    t = torch.from_numpy
    close(port_common.rms_norm(t(x), t(s), 1e-6),
          ref_common.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))
    close(port_common.layer_norm(t(x), t(s), t(b), 1e-5),
          ref_common.layer_norm(jnp.asarray(x), jnp.asarray(s),
                                jnp.asarray(b), 1e-5))
    for cap in (None, 30.0, 2.0):
        close(port_common.softcap(t(x), cap),
              ref_common.softcap(jnp.asarray(x), cap))
    # bf16 in, bf16 out, computed in fp32
    xb = t(x).to(torch.bfloat16)
    got = port_common.rms_norm(xb, t(s), 1e-6)
    want = ref_common.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s),
                               1e-6)
    assert got.dtype is torch.bfloat16
    close(got.float(), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_act_fn(name):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    close(port_common.act_fn(name)(torch.from_numpy(x)),
          ref_common.act_fn(name)(jnp.asarray(x)))


@pytest.mark.parametrize("head_axis", [True, False])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta, head_axis):
    r = rng(2)
    shape = (2, 9, 3, 16) if head_axis else (2, 9, 16)
    x = normal(r, *shape)
    pos = r.integers(0, 5000, (2, 9)).astype(np.int32)
    close(port_common.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
          ref_common.rope(jnp.asarray(x), jnp.asarray(pos), theta),
          rtol=1e-5, atol=2e-5)


def test_sinusoids():
    close(port_common.sinusoidal_positions(40, 16),
          ref_common.sinusoidal_positions(40, 16))
    pos = np.array([[0, 3, 700], [5, 6, 9000]], np.int32)
    close(port_common.sinusoidal_at(torch.from_numpy(pos), 12),
          ref_common.sinusoidal_at(jnp.asarray(pos), 12), rtol=1e-5,
          atol=2e-5)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act, gated):
    ref_cfg, port_cfg = cfgs(act=act)
    p = ref_common.init_mlp(jax.random.PRNGKey(3), 32, 48, ref_cfg, gated)
    x = normal(rng(3), 2, 5, 32)
    close(port_common.apply_mlp(to_port(p), torch.from_numpy(x), port_cfg),
          ref_common.apply_mlp(p, jnp.asarray(x), ref_cfg))
    got = port_common.init_mlp(torch.Generator().manual_seed(0), 32, 48,
                               port_cfg, gated, device="cpu")
    assert sorted(got) == sorted(p)
    for k in p:
        assert tuple(got[k].shape) == p[k].shape
        assert got[k].dtype is torch.float32
        # truncated at 2 standard deviations of 1/sqrt(fan-in)
        fan_in = 32 if k in ("wi", "wg") else 48
        assert float(got[k].abs().max()) <= 2.0 / math.sqrt(fan_in) + 1e-6


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("gemma", [True, False])
def test_embed_and_unembed(tied, gemma):
    ref_cfg, port_cfg = cfgs(
        tie_embeddings=tied, embed_scale=gemma,
        final_softcap=30.0 if gemma else None, d_model=48)
    p = ref_common.init_embed(jax.random.PRNGKey(4), ref_cfg)
    tokens = rng(4).integers(0, 64, (2, 7)).astype(np.int32)
    pp = to_port(p)
    close(port_common.embed_tokens(pp, torch.from_numpy(tokens), port_cfg),
          ref_common.embed_tokens(p, jnp.asarray(tokens), ref_cfg))
    h = normal(rng(5), 2, 7, 48)
    close(port_common.unembed(pp, torch.from_numpy(h), port_cfg),
          ref_common.unembed(p, jnp.asarray(h), ref_cfg))


def _scan_combine(lhs, rhs):
    # the reference's combine (``models/ssm.py``, ``models/rglru.py``)
    return lhs[0] * rhs[0], lhs[1] * rhs[0] + rhs[1]


ref_scan = jax.jit(lambda a, b: jax.lax.associative_scan(
    _scan_combine, (a, b), axis=1))


@pytest.mark.parametrize("shape", ["rglru", "ssd"])
@pytest.mark.parametrize("L", [1, 2, 7, 64, 1000])
def test_linear_scan_matches_a_sequential_loop(L, shape):
    """``common.linear_scan`` (fp32, log-depth) against the recurrence
    run position by position in float64 and against the reference's
    ``jax.lax.associative_scan``.  ``bb`` (the state) within 1e-6 of the
    largest state (a state near 0 is a difference of larger terms):
    measured at most 2.5e-7.  ``aa``, a product of up to L fp32 factors,
    rounds L - 1 times in any order, so it is held at 4e-6 relative:
    measured 5.1e-7 at L = 64 and 1.7e-6 at 1,000 against the loop (the
    reference's own scan: 1.3e-6).  ``ssd``: ``a`` broadcasts over a
    trailing axis."""
    r = rng(L)
    a = r.uniform(0.9, 1.0, (2, L, 3, 1) if shape == "ssd" else (2, L, 3))
    a = a.astype(np.float32)
    b = normal(r, *((2, L, 3, 4) if shape == "ssd" else (2, L, 3)))
    aa, bb = port_common.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                                     dim=1)
    assert aa.dtype is bb.dtype is torch.float32
    assert tuple(aa.shape) == a.shape and tuple(bb.shape) == b.shape
    want_a, want_b = np.empty(a.shape), np.empty(b.shape)
    ha, hb = np.ones(a[:, 0].shape), np.zeros(b[:, 0].shape)
    for t in range(L):
        ha, hb = ha * a[:, t], hb * a[:, t] + b[:, t]
        want_a[:, t], want_b[:, t] = ha, hb
    for wa, wb in ((want_a, want_b), ref_scan(jnp.asarray(a),
                                              jnp.asarray(b))):
        close(aa, wa, rtol=4e-6, atol=0)
        close(bb, wb, rtol=0, atol=1e-6 * float(np.abs(want_b).max()))


def test_embed_scale_rounds_to_the_activation_dtype():
    """bf16: sqrt(3584) = 59.87 is 59.75 before it scales, as in the
    reference."""
    ref_cfg, port_cfg = cfgs(embed_scale=True, d_model=3584, vocab_size=4)
    ref_cfg = ref_cfg.__class__(**{**ref_cfg.__dict__, "dtype": jnp.bfloat16})
    port_cfg = port_cfg.reduced(d_model=3584, vocab_size=4,
                                dtype=torch.bfloat16)
    table = np.ones((4, 3584), np.float32)
    got = port_common.embed_tokens(to_port({"table": table}),
                                   torch.tensor([[1]]), port_cfg)
    want = ref_common.embed_tokens({"table": jnp.asarray(table)},
                                   jnp.asarray([[1]]), ref_cfg)
    assert got.dtype is torch.bfloat16
    assert float(got[0, 0, 0]) == 59.75 == float(want[0, 0, 0])


# ---------------------------------------------------------------------------
# attention.py: masks and the attention cores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,causal", [
    ("global", True), ("local", True), ("global", False), ("local", False)])
def test_make_mask(kind, causal):
    r = rng(6)
    q_pos = r.integers(0, 40, (2, 7)).astype(np.int32)
    kv_pos = r.integers(-1, 40, (2, 11)).astype(np.int32)   # -1 = empty
    got = port_attn.make_mask(torch.from_numpy(q_pos),
                              torch.from_numpy(kv_pos), kind, 6, causal)
    want = ref_attn.make_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), kind,
                              6, causal)
    assert got.dtype is torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _qkv(seed, B, Lq, Lk, H, KV, hd):
    r = rng(seed)
    return normal(r, B, Lq, H, hd), normal(r, B, Lk, KV, hd), \
        normal(r, B, Lk, KV, hd)


@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
def test_sdpa_dense(H, KV, softcap):
    ref_cfg, port_cfg = cfgs(n_heads=H, n_kv_heads=KV, attn_softcap=softcap,
                             window=5)
    q, k, v = _qkv(7, 2, 9, 13, H, KV, 8)
    pos_q = np.broadcast_to(np.arange(4, 13), (2, 9)).astype(np.int32)
    pos_k = np.broadcast_to(np.arange(13), (2, 13)).astype(np.int32)
    t = torch.from_numpy
    mask = ref_attn.make_mask(jnp.asarray(pos_q), jnp.asarray(pos_k),
                              "local", 5)
    close(port_attn._sdpa_dense(t(q), t(k), t(v), t(np.array(mask)),
                                port_cfg, 0.3),
          ref_attn._sdpa_dense(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), mask, ref_cfg, 0.3))


@pytest.fixture
def shrunk_blocks(monkeypatch):
    """Both packages' flash blocks shrunk, the reference's restored after."""
    def shrink(cq, ck):
        for mod in (ref_attn, port_attn):
            monkeypatch.setattr(mod, "Q_BLOCK", cq)
            monkeypatch.setattr(mod, "KV_BLOCK", ck)
    return shrink


@pytest.mark.parametrize("kind,causal", [
    ("global", True), ("local", True), ("global", False)])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
def test_flash_equals_both_dense_paths(shrunk_blocks, kind, causal, H, KV):
    ref_cfg, port_cfg = cfgs(n_heads=H, n_kv_heads=KV, window=48)
    q, k, v = _qkv(8, 2, 96, 96, H, KV, 16)
    pos = np.broadcast_to(np.arange(96), (2, 96)).astype(np.int32)
    t = torch.from_numpy
    mask = port_attn.make_mask(t(pos), t(pos), kind, 48, causal)
    port_dense = port_attn._sdpa_dense(t(q), t(k), t(v), mask, port_cfg,
                                       0.25)
    ref_dense = ref_attn._sdpa_dense(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(mask.numpy()), ref_cfg, 0.25)
    shrunk_blocks(32, 24)
    got = port_attn._sdpa_flash(t(q), t(k), t(v), t(pos), t(pos), kind,
                                causal, port_cfg, 0.25)
    close(got, port_dense)
    close(got, ref_dense)
    close(got, ref_attn._sdpa_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), kind, causal, ref_cfg, 0.25))


def test_flash_with_softcap_and_ragged_lengths(shrunk_blocks):
    ref_cfg, port_cfg = cfgs(attn_softcap=30.0)
    q, k, v = _qkv(9, 1, 50, 70, 4, 2, 16)
    qpos = np.broadcast_to(np.arange(20, 70), (1, 50)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(70), (1, 70)).astype(np.int32)
    t = torch.from_numpy
    mask = port_attn.make_mask(t(qpos), t(kpos), "global", 0, True)
    want = ref_attn._sdpa_dense(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask.numpy()),
                                ref_cfg, 0.25)
    shrunk_blocks(16, 32)
    got = port_attn._sdpa_flash(t(q), t(k), t(v), t(qpos), t(kpos),
                                "global", True, port_cfg, 0.25)
    close(got, want)
    close(got, port_attn._sdpa_dense(t(q), t(k), t(v), mask, port_cfg, 0.25))


def test_sdpa_positions_dispatches_on_key_length(monkeypatch):
    """Past ``_DENSE_MAX`` keys a multi-query call takes the flash path;
    decode (one query) never does."""
    _, port_cfg = cfgs()
    calls = []
    monkeypatch.setattr(port_attn, "_DENSE_MAX", 8)
    real = port_attn._sdpa_flash
    monkeypatch.setattr(port_attn, "_sdpa_flash",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v = (torch.from_numpy(a) for a in _qkv(10, 1, 9, 9, 4, 2, 8))
    pos = torch.arange(9)[None]
    port_attn._sdpa_positions(q, k, v, pos, pos, "global", True, port_cfg,
                              0.3)
    port_attn._sdpa_positions(q[:, -1:], k, v, pos[:, -1:], pos, "global",
                              True, port_cfg, 0.3)
    assert calls == [1]


# ---------------------------------------------------------------------------
# apply_attention
# ---------------------------------------------------------------------------

def _attn_params(ref_cfg, seed=11):
    p = ref_attn.init_attention(jax.random.PRNGKey(seed), ref_cfg)
    if ref_cfg.qk_norm:                 # non-zero scales, so the norm shows
        r = rng(seed)
        p = dict(p, q_norm=jnp.asarray(normal(r, ref_cfg.head_dim_)) * 0.3,
                 k_norm=jnp.asarray(normal(r, ref_cfg.head_dim_)) * 0.3)
    return p, to_port(p)


def _port_cache(cache):
    return port_attn.KVCache(*(torch.from_numpy(np.array(a))
                               for a in cache))


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("kind", ["global", "local"])
def test_apply_attention_without_cache(kind, qk_norm):
    ref_cfg, port_cfg = cfgs(qk_norm=qk_norm, window=4, attn_softcap=40.0)
    p, pp = _attn_params(ref_cfg)
    x = normal(rng(12), 2, 10, 32)
    pos = np.broadcast_to(np.arange(10), (2, 10)).astype(np.int32)
    got, gc = port_attn.apply_attention(pp, torch.from_numpy(x),
                                        torch.from_numpy(pos), port_cfg, kind)
    want, wc = ref_apply_attention(p, jnp.asarray(x), jnp.asarray(pos),
                                        ref_cfg, kind)
    assert gc is None and wc is None
    close(got, want)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("kind,L,window", [
    ("global", 7, 16), ("local", 7, 16),   # the prompt inside the window
    ("local", 16, 8)])                     # a multiple of the ring's size
def test_apply_attention_prefill_then_decode(kind, L, window, qk_norm):
    """Prefill fills the cache; each decode step's output and cache slots
    equal the reference's where its ring layout agrees (L <= S, or L a
    multiple of S)."""
    ref_cfg, port_cfg = cfgs(qk_norm=qk_norm, window=window)
    p, pp = _attn_params(ref_cfg)
    B, steps = 2, 5
    x = normal(rng(13), B, L + steps, 32)
    pos = np.broadcast_to(np.arange(L + steps), (B, L + steps)).astype(
        np.int32)
    ref_cache = ref_attn.init_kv_cache(ref_cfg, B, L + 8, kind)
    port_cache = port_attn.init_kv_cache(port_cfg, B, L + 8, kind)
    assert tuple(port_cache.k.shape) == ref_cache.k.shape
    want, ref_cache = ref_apply_attention(
        p, jnp.asarray(x[:, :L]), jnp.asarray(pos[:, :L]), ref_cfg, kind,
        cache=ref_cache)
    got, port_cache = port_attn.apply_attention(
        pp, torch.from_numpy(x[:, :L]), torch.from_numpy(pos[:, :L]),
        port_cfg, kind, cache=port_cache)
    close(got, want)
    for g, w in zip(port_cache, ref_cache):
        close(g, w)
    for t in range(L, L + steps):
        want, ref_cache = ref_apply_attention(
            p, jnp.asarray(x[:, t:t + 1]), jnp.asarray(pos[:, t:t + 1]),
            ref_cfg, kind, cache=ref_cache, cache_index=jnp.asarray(t))
        got, port_cache = port_attn.apply_attention(
            pp, torch.from_numpy(x[:, t:t + 1]),
            torch.from_numpy(pos[:, t:t + 1]), port_cfg, kind,
            cache=port_cache, cache_index=t)
        close(got, want)
        for g, w in zip(port_cache, ref_cache):
            close(g, w)


def test_local_ring_past_the_window_keeps_decode_exact():
    """A prompt past the window and not a multiple of it (ROADMAP queue 3):
    the port's prefill puts each kept key at ``position % S``, so every
    decode step equals attention over the full sequence, which the
    reference's ring does not."""
    ref_cfg, port_cfg = cfgs(window=8)
    p, pp = _attn_params(ref_cfg)
    B, L, steps = 2, 13, 6
    x = normal(rng(14), B, L + steps, 32)
    pos = np.broadcast_to(np.arange(L + steps), (B, L + steps)).astype(
        np.int32)
    full, _ = ref_apply_attention(p, jnp.asarray(x), jnp.asarray(pos),
                                       ref_cfg, "local")
    cache = port_attn.init_kv_cache(port_cfg, B, L + 8, "local")
    _, cache = port_attn.apply_attention(
        pp, torch.from_numpy(x[:, :L]), torch.from_numpy(pos[:, :L]),
        port_cfg, "local", cache=cache)
    np.testing.assert_array_equal(cache.pos[0].numpy() % 8, np.arange(8))
    for t in range(L, L + steps):
        got, cache = port_attn.apply_attention(
            pp, torch.from_numpy(x[:, t:t + 1]),
            torch.from_numpy(pos[:, t:t + 1]), port_cfg, "local",
            cache=cache, cache_index=t)
        close(got, np.asarray(full)[:, t:t + 1])


def test_a_local_cache_under_the_window_grows_into_the_ring():
    """A local layer's cache shorter than the window (a short prompt plus
    the headroom) grows into the full ring when decode reaches its end,
    then wraps: every decode step equals attention over the full
    sequence (the reference's ``p % S`` wraps the short cache onto keys
    still inside the window: ROADMAP queue 3)."""
    ref_cfg, port_cfg = cfgs(window=12)
    p, pp = _attn_params(ref_cfg)
    B, L, steps = 2, 5, 15                   # positions 5..19: past 8, 12
    x = normal(rng(17), B, L + steps, 32)
    pos = np.broadcast_to(np.arange(L + steps), (B, L + steps)).astype(
        np.int32)
    full, _ = ref_apply_attention(p, jnp.asarray(x), jnp.asarray(pos),
                                  ref_cfg, "local")
    cache = port_attn.init_kv_cache(port_cfg, B, 8, "local")
    assert tuple(cache.k.shape[:2]) == (B, 8)
    _, cache = port_attn.apply_attention(
        pp, torch.from_numpy(x[:, :L]), torch.from_numpy(pos[:, :L]),
        port_cfg, "local", cache=cache)
    for t in range(L, L + steps):
        got, cache = port_attn.apply_attention(
            pp, torch.from_numpy(x[:, t:t + 1]),
            torch.from_numpy(pos[:, t:t + 1]), port_cfg, "local",
            cache=cache, cache_index=t)
        close(got, np.asarray(full)[:, t:t + 1])
        assert cache.k.shape[1] == (8 if t < 8 else 12)
    np.testing.assert_array_equal(np.sort(cache.pos[0].numpy()),
                                  np.arange(8, 20))


def test_decode_past_the_cache_raises():
    ref_cfg, port_cfg = cfgs()
    _, pp = _attn_params(ref_cfg)
    cache = port_attn.init_kv_cache(port_cfg, 1, 4, "global")
    x = torch.zeros((1, 1, 32))
    port_attn.apply_attention(pp, x, torch.tensor([[3]]), port_cfg,
                              cache=cache, cache_index=3)
    with pytest.raises(ValueError, match="GEN_MARGIN"):
        port_attn.apply_attention(pp, x, torch.tensor([[4]]), port_cfg,
                                  cache=cache, cache_index=4)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention(qk_norm):
    """Cross-attention memory passed as ``kv`` and as a precomputed
    ``project_cross_kv`` cache."""
    ref_cfg, port_cfg = cfgs(qk_norm=qk_norm)
    p, pp = _attn_params(ref_cfg)
    r = rng(15)
    x, mem = normal(r, 2, 6, 32), normal(r, 2, 11, 32)
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    mpos = np.broadcast_to(np.arange(11), (2, 11)).astype(np.int32)
    t = torch.from_numpy
    want, _ = ref_apply_attention(p, jnp.asarray(x), jnp.asarray(pos),
                                       ref_cfg, kv=jnp.asarray(mem),
                                       kv_pos=jnp.asarray(mpos),
                                       causal=False)
    got, _ = port_attn.apply_attention(pp, t(x), t(pos), port_cfg, kv=t(mem),
                                       kv_pos=t(mpos), causal=False)
    close(got, want)
    ref_cc = ref_attn.project_cross_kv(p, jnp.asarray(mem),
                                       jnp.asarray(mpos), ref_cfg)
    port_cc = port_attn.project_cross_kv(pp, t(mem), t(mpos), port_cfg)
    for g, w in zip(port_cc, ref_cc):
        close(g, w)
    want, _ = ref_apply_attention(p, jnp.asarray(x), jnp.asarray(pos),
                                       ref_cfg, cross_cache=ref_cc)
    got, none = port_attn.apply_attention(pp, t(x), t(pos), port_cfg,
                                          cross_cache=port_cc)
    assert none is None
    close(got, want)


def test_mla_is_item_16b():
    """Item 16b's MLA, ported: it builds the reference's parameters,
    caches the latent in the reference's layout, and applies as the
    reference does through ``apply_attention``."""
    ref_cfg, port_cfg = cfgs(use_mla=True, kv_lora_rank=16, q_lora_rank=24,
                             qk_nope_head_dim=8, qk_rope_head_dim=8,
                             v_head_dim=12)
    want = ref_attn.init_attention(jax.random.PRNGKey(16), ref_cfg)
    got = port_attn.init_attention(torch.Generator().manual_seed(0),
                                   port_cfg, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
    ref_cache = ref_attn.init_mla_cache(ref_cfg, 2, 12)
    cache = port_attn.init_mla_cache(port_cfg, 2, 12)
    assert isinstance(cache, port_attn.MLACache)
    assert cache._fields == ref_cache._fields == ("c_kv", "k_rope", "pos")
    for g, w in zip(cache, ref_cache):
        assert tuple(g.shape) == w.shape
        close(g, w)
    x = normal(rng(16), 2, 9, 32)
    pos = np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)
    pp = to_port(want)
    out, cache = port_attn.apply_attention(
        pp, torch.from_numpy(x), torch.from_numpy(pos), port_cfg,
        cache=cache)
    ref_out, ref_cache = ref_apply_attention(
        want, jnp.asarray(x), jnp.asarray(pos), ref_cfg, cache=ref_cache)
    close(out, ref_out)
    for g, w in zip(cache, ref_cache):
        close(g, w)
