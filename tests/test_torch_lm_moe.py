"""The port's MoE FFN (``repro_torch.models.moe``) and MLA latent attention
(``attention.apply_mla``) against the reference's on the same numpy
inputs, and the two ``moe``-family archs' decoder against the reference's
at ``reduced()`` width with dropped pairs.

Routing integers (experts, slots, keep) equal the reference's exactly,
with capacity drops and planted router ties; weights and the auxiliary
loss agree within 1e-6.  ``apply_moe`` agrees within 1e-5 (fp32) and
2e-2 (bf16), ``apply_mla`` within 1e-5 at prefill and decode, with and
without ``q_lora_rank``, expanded and absorbed.  Nothing here changes
process-wide state: reference calls go through ``jax.jit``, and the
attention block sizes a test shrinks are restored by ``monkeypatch``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import moe as ref_moe
from repro_torch import configs as port_configs
from repro_torch.models import attention as port_attn
from repro_torch.models import moe as port_moe
from test_torch_lm_layers import cfgs, close, normal, ref_apply_attention, \
    rng, to_port
from test_torch_lm_serve import TOL as LM_TOL
from test_torch_lm_serve import logits_np, pair, step_both, tokens

MOE_ARCHS = ["deepseek-v2-236b", "qwen2-moe-a2.7b"]
ROUTE_TOL = dict(rtol=1e-6, atol=1e-6)
# apply_moe against the reference: fp32 within 1e-5 (measured at most
# 8.6e-6, deepseek's outputs up to 20.0 under routed_scaling 16; 5.1e-7 on
# qwen2-moe's up to 2.1); bf16 within 2e-2 of the output's largest
# magnitude, since a routed term is that large and one bf16 ulp of it
# shows in any output element (measured 0.125 of 19.9, 6.3e-3, and 0.0156
# of 2.06, 7.6e-3)
MOE_FP32_TOL = dict(rtol=1e-5, atol=1e-5)
MOE_BF16_SCALE_TOL = 2e-2

ref_route = jax.jit(ref_moe._route, static_argnames=("cfg",))
ref_apply_moe = jax.jit(ref_moe.apply_moe, static_argnames=("cfg",))


def moe_cfgs(arch, **overrides):
    """``arch``'s reduced config in both packages, with ``overrides``."""
    ref_cfg = ref_configs.get_config(arch, reduced=True)
    port_cfg = port_configs.get_config(arch, reduced=True)
    if overrides:
        jax_dtypes = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
        ref_cfg = ref_cfg.reduced(**{
            k: (jax_dtypes[v] if k == "dtype" else v)
            for k, v in overrides.items()})
        port_cfg = port_cfg.reduced(**overrides)
    return ref_cfg, port_cfg


def to_port_moe(p):
    """The reference's MoE parameter dict as the port's ``MoEParams``."""
    m = port_moe.MoEParams()
    for key, val in p.items():
        if isinstance(val, dict):
            setattr(m, key, to_port(val))
        else:
            setattr(m, key, torch.nn.Parameter(
                torch.from_numpy(np.array(val, np.float32)),
                requires_grad=False))
    return m


def moe_params(ref_cfg, seed=0):
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg)
    return p, to_port_moe(p)


def ref_slots(experts, cfg):
    """The reference's slot assignment, as ``_apply_moe_scatter`` computes
    it (``src/repro/models/moe.py``, the lines after ``_route``), which it
    does not return: (slot, keep, capacity)."""
    T, K = experts.shape
    flat_exp = experts.reshape(T * K)
    onehot = jax.nn.one_hot(flat_exp, cfg.n_experts, dtype=jnp.int32)
    pos_in_expert = jnp.cumsum(onehot, axis=0) - onehot
    slot = jnp.take_along_axis(pos_in_expert, flat_exp[:, None], axis=1)[:, 0]
    capacity = min(max(int((T * K * cfg.capacity_factor) / cfg.n_experts),
                       min(8, T)), T)
    return np.asarray(slot), np.asarray(slot < capacity), capacity


def loop_slots(experts):
    """Each pair's slot by its definition: the pairs before it, in
    token-major order, routed to the same expert."""
    seen = {}
    slots = []
    for e in experts.reshape(-1).tolist():
        slots.append(seen.get(e, 0))
        seen[e] = slots[-1] + 1
    return np.array(slots)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [None, 1.0], ids=["dropless", "cf1"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_and_slots_match_the_reference(arch, cf):
    """64 tokens: dropless at the reduced config's cf = E / K = 4, and at
    cf = 1.0, where the capacity is T·K/E = 16 and pairs are dropped."""
    ref_cfg, port_cfg = moe_cfgs(arch, **(
        {} if cf is None else {"capacity_factor": cf}))
    p, pp = moe_params(ref_cfg, seed=1)
    x = normal(rng(21), 64, port_cfg.d_model)
    rw, re, raux = ref_route(p, jnp.asarray(x), ref_cfg)
    pw, pe, paux = port_moe._route(pp, torch.from_numpy(x), port_cfg)
    np.testing.assert_array_equal(pe.numpy(), np.asarray(re))
    close(pw, rw, **ROUTE_TOL)
    close(paux, raux, **ROUTE_TOL)
    assert pw.dtype is paux.dtype is torch.float32

    flat_exp, slot, keep, capacity = port_moe._slots(pe, port_cfg)
    want_slot, want_keep, want_capacity = ref_slots(re, ref_cfg)
    assert capacity == want_capacity
    np.testing.assert_array_equal(flat_exp.numpy(), np.asarray(re).ravel())
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(slot.numpy(), loop_slots(np.asarray(re)))
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    T, K = 64, port_cfg.top_k
    if cf is None:
        assert capacity == T and keep.all()
    else:
        assert capacity == T * K // port_cfg.n_experts == 16
        assert 0 < int((~keep).sum()) < T * K


def test_top_k_breaks_ties_as_lax_top_k():
    probs = np.array([[0.1, 0.3, 0.3, 0.1, 0.2],
                      [0.25, 0.25, 0.25, 0.25, 0.0],
                      [0.0, 0.2, 0.2, 0.3, 0.3],
                      [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    for k in (1, 2, 3, 5):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = port_moe._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def _tied_router(ref_cfg, p, seed):
    """A router whose columns 0 = 3, 2 = 5 and 4 = 7, with inputs of
    quarter-integers and a router of -1, 0, 1, so every logit is exact
    and tied experts tie bitwise."""
    r = rng(seed)
    d, E = ref_cfg.d_model, ref_cfg.n_experts
    router = r.integers(-1, 2, (d, E)).astype(np.float32)
    for a, b in ((0, 3), (2, 5), (4, 7)):
        router[:, b] = router[:, a]
    x = r.integers(-1, 2, (48, d)).astype(np.float32) * 0.25
    return dict(p, router=jnp.asarray(router)), x


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_planted_router_ties_pick_the_reference_expert(arch):
    """Where two experts tie within a token's top K, or across its K-th
    place, the port picks the reference's: the lower index first.  The
    whole MoE output follows."""
    ref_cfg, port_cfg = moe_cfgs(arch, capacity_factor=1.0)
    p, _ = moe_params(ref_cfg, seed=2)
    p, x = _tied_router(ref_cfg, p, seed=22)
    pp = to_port_moe(p)
    rw, re, raux = ref_route(p, jnp.asarray(x), ref_cfg)
    pw, pe, paux = port_moe._route(pp, torch.from_numpy(x), port_cfg)
    np.testing.assert_array_equal(pe.numpy(), np.asarray(re))
    close(pw, rw, **ROUTE_TOL)
    close(paux, raux, **ROUTE_TOL)
    # the ties are real in both packages: within some tokens' top K, and
    # across the K-th place of others
    K = port_cfg.top_k
    for probs in (torch.softmax(torch.from_numpy(x) @ pp.router, -1).numpy(),
                  np.asarray(jax.nn.softmax(jnp.asarray(x) @ p["router"]))):
        top = -np.sort(-probs, axis=-1)
        assert (top[:, :K - 1] == top[:, 1:K]).any(axis=1).sum() >= 3
        assert (top[:, K - 1] == top[:, K]).sum() >= 3
    xb = x.reshape(3, 16, -1)
    got, gaux = port_moe.apply_moe(pp, torch.from_numpy(xb), port_cfg)
    want, waux = ref_apply_moe(p, jnp.asarray(xb), ref_cfg)
    close(got, want, **MOE_FP32_TOL)
    close(gaux, waux, **ROUTE_TOL)


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("cf", [None, 1.0], ids=["dropless", "cf1"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_the_reference(arch, cf, dtype):
    overrides = {"dtype": dtype}
    if cf is not None:
        overrides["capacity_factor"] = cf
    ref_cfg, port_cfg = moe_cfgs(arch, **overrides)
    p, pp = moe_params(ref_cfg, seed=3)
    x = normal(rng(23), 4, 16, port_cfg.d_model)
    got, gaux = port_moe.apply_moe(pp, torch.from_numpy(x).to(dtype),
                                   port_cfg)
    want, waux = ref_apply_moe(p, jnp.asarray(x, ref_cfg.dtype), ref_cfg)
    assert got.dtype is dtype and tuple(got.shape) == want.shape
    assert gaux.dtype is torch.float32
    want = np.asarray(want, np.float32)
    if dtype is torch.float32:
        close(got, want, **MOE_FP32_TOL)
    else:
        err = np.abs(got.float().numpy() - want).max()
        assert err <= MOE_BF16_SCALE_TOL * np.abs(want).max(), err
    close(gaux, waux, **ROUTE_TOL)


def test_dropped_pairs_add_nothing():
    """At cf = 1.0 each token's output is its kept pairs' weighted expert
    FFNs plus the shared experts, computed token by token: a dropped pair
    adds nothing anywhere, and a parked one disturbs no kept pair."""
    ref_cfg, port_cfg = moe_cfgs("qwen2-moe-a2.7b", capacity_factor=1.0)
    _, pp = moe_params(ref_cfg, seed=4)
    x = torch.from_numpy(normal(rng(24), 4, 16, port_cfg.d_model))
    got, _ = port_moe.apply_moe(pp, x, port_cfg)
    xf = x.reshape(64, -1)
    weights, experts, _ = port_moe._route(pp, xf, port_cfg)
    _, _, keep, _ = port_moe._slots(experts, port_cfg)
    keep = keep.view(64, -1)
    assert not keep.all()
    act = torch.nn.functional.silu
    for t in range(64):
        want = torch.zeros(port_cfg.d_model)
        for k in range(port_cfg.top_k):
            if keep[t, k]:
                e = int(experts[t, k])
                h = act(xf[t] @ pp.wg[e]) * (xf[t] @ pp.wi[e])
                want = want + weights[t, k] * (h @ pp.wo[e])
        sh = pp.shared
        want = want + (act(xf[t] @ sh["wg"]) * (xf[t] @ sh["wi"])) @ sh["wo"]
        torch.testing.assert_close(got.reshape(64, -1)[t], want, rtol=1e-5,
                                   atol=1e-5)


def test_apply_moe_is_bitwise_run_to_run():
    ref_cfg, port_cfg = moe_cfgs("deepseek-v2-236b", capacity_factor=1.0)
    _, pp = moe_params(ref_cfg, seed=5)
    x = torch.from_numpy(normal(rng(25), 4, 16, port_cfg.d_model))
    a, aux_a = port_moe.apply_moe(pp, x, port_cfg)
    b, aux_b = port_moe.apply_moe(pp, x, port_cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


@pytest.mark.parametrize("arch,E,rows", [
    ("qwen2-moe-a2.7b", 60, 64), ("deepseek-v2-236b", 160, 160)])
def test_init_moe_pads_the_experts_as_the_reference(arch, E, rows):
    full_ref = ref_configs.get_config(arch)
    assert ref_moe.padded_experts(full_ref) == rows
    assert port_moe.padded_experts(port_configs.get_config(arch)) == rows
    assert port_moe.EXPERT_PAD == ref_moe.EXPERT_PAD
    assert full_ref.n_experts == E
    ref_cfg, port_cfg = moe_cfgs(arch)
    want = ref_moe.init_moe(jax.random.PRNGKey(0), ref_cfg)
    got = port_moe.init_moe(torch.Generator().manual_seed(0), port_cfg,
                            device="cpu")
    assert tuple(got.wi.shape) == want["wi"].shape == (16, 64, 32)
    for key, val in want.items():
        assert key in got
        if isinstance(val, dict):
            for sub, arr in val.items():
                assert tuple(got[key][sub].shape) == arr.shape
        else:
            assert tuple(got[key].shape) == val.shape
            assert got[key].dtype is torch.float32


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def mla_cfgs(q_lora, absorb, **kw):
    return cfgs(use_mla=True, kv_lora_rank=16, q_lora_rank=q_lora,
                qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=12,
                mla_absorb=absorb, n_kv_heads=4, **kw)


def mla_params(ref_cfg, seed=31):
    p = ref_attn.init_attention(jax.random.PRNGKey(seed), ref_cfg)
    r = rng(seed)                       # non-zero norm scales, so they show
    p = dict(p, kv_norm=jnp.asarray(normal(r, ref_cfg.kv_lora_rank)) * 0.3)
    if ref_cfg.q_lora_rank:
        p["q_norm"] = jnp.asarray(normal(r, ref_cfg.q_lora_rank)) * 0.3
    return p, to_port(p)


@pytest.mark.parametrize("absorb", [False, True], ids=["expanded",
                                                       "absorbed"])
@pytest.mark.parametrize("q_lora", [24, None], ids=["q_lora", "no_q_lora"])
def test_apply_mla_prefill_then_decode(q_lora, absorb):
    """The latent cache after prefill and after each of 5 decode steps,
    and every call's output, equal the reference's."""
    ref_cfg, port_cfg = mla_cfgs(q_lora, absorb)
    p, pp = mla_params(ref_cfg)
    B, L, steps = 2, 7, 5
    x = normal(rng(32), B, L + steps, 32)
    pos = np.broadcast_to(np.arange(L + steps), (B, L + steps)).astype(
        np.int32)
    ref_cache = ref_attn.init_mla_cache(ref_cfg, B, L + 8)
    port_cache = port_attn.init_mla_cache(port_cfg, B, L + 8)
    assert isinstance(port_cache, port_attn.MLACache)
    for g, w in zip(port_cache, ref_cache):
        assert tuple(g.shape) == w.shape
        close(g, w)
    want, ref_cache = ref_apply_attention(
        p, jnp.asarray(x[:, :L]), jnp.asarray(pos[:, :L]), ref_cfg,
        cache=ref_cache)
    got, port_cache = port_attn.apply_attention(
        pp, torch.from_numpy(x[:, :L]), torch.from_numpy(pos[:, :L]),
        port_cfg, cache=port_cache)
    close(got, want)
    for g, w in zip(port_cache, ref_cache):
        close(g, w)
    for t in range(L, L + steps):
        want, ref_cache = ref_apply_attention(
            p, jnp.asarray(x[:, t:t + 1]), jnp.asarray(pos[:, t:t + 1]),
            ref_cfg, cache=ref_cache, cache_index=jnp.asarray(t))
        got, port_cache = port_attn.apply_attention(
            pp, torch.from_numpy(x[:, t:t + 1]),
            torch.from_numpy(pos[:, t:t + 1]), port_cfg, cache=port_cache,
            cache_index=t)
        close(got, want)
        for g, w in zip(port_cache, ref_cache):
            close(g, w)


@pytest.mark.parametrize("q_lora", [24, None], ids=["q_lora", "no_q_lora"])
def test_apply_mla_without_cache(q_lora):
    ref_cfg, port_cfg = mla_cfgs(q_lora, False)
    p, pp = mla_params(ref_cfg, seed=34)
    x = normal(rng(34), 2, 10, 32)
    pos = np.broadcast_to(np.arange(10), (2, 10)).astype(np.int32)
    got, gc = port_attn.apply_attention(pp, torch.from_numpy(x),
                                        torch.from_numpy(pos), port_cfg)
    want, wc = ref_apply_attention(p, jnp.asarray(x), jnp.asarray(pos),
                                   ref_cfg)
    assert gc is None and wc is None
    close(got, want)


@pytest.fixture
def shrunk_attention(monkeypatch):
    """Both packages' dense limit and flash blocks shrunk (the reference's
    restored after), so a short prompt takes the flash path."""
    for mod in (ref_attn, port_attn):
        monkeypatch.setattr(mod, "_DENSE_MAX", 16)
        monkeypatch.setattr(mod, "Q_BLOCK", 8)
        monkeypatch.setattr(mod, "KV_BLOCK", 12)


def test_mla_prefill_on_the_flash_path(shrunk_attention, monkeypatch):
    """A 29-token prompt past the shrunk dense limit: the expanded path's
    q/k head (nope + rope = 16) is wider than v's (12) in the flash loop
    too."""
    ref_cfg, port_cfg = mla_cfgs(24, False)
    p, pp = mla_params(ref_cfg, seed=35)
    calls = []
    real = port_attn._sdpa_flash
    monkeypatch.setattr(port_attn, "_sdpa_flash",
                        lambda *a: calls.append(a[2].shape) or real(*a))
    x = normal(rng(35), 1, 29, 32)
    pos = np.arange(29, dtype=np.int32)[None]
    ref_cache = ref_attn.init_mla_cache(ref_cfg, 1, 31)
    port_cache = port_attn.init_mla_cache(port_cfg, 1, 31)
    want, _ = ref_apply_attention(p, jnp.asarray(x), jnp.asarray(pos),
                                  ref_cfg, cache=ref_cache)
    got, _ = port_attn.apply_attention(pp, torch.from_numpy(x),
                                       torch.from_numpy(pos), port_cfg,
                                       cache=port_cache)
    assert calls == [(1, 29, 4, 12)]
    close(got, want)


@pytest.mark.parametrize("path", ["dense", "flash"])
def test_attention_core_takes_v_head_dim_from_v(shrunk_attention, path):
    """q/k heads of 24, v heads of 16: both cores return v's width, and
    equal the reference's."""
    ref_cfg, port_cfg = cfgs(n_heads=4, n_kv_heads=4)
    r = rng(36)
    q, k, v = normal(r, 2, 20, 4, 24), normal(r, 2, 20, 4, 24), \
        normal(r, 2, 20, 4, 16)
    pos = np.broadcast_to(np.arange(20), (2, 20)).astype(np.int32)
    t = torch.from_numpy
    if path == "dense":
        mask = ref_attn.make_mask(jnp.asarray(pos), jnp.asarray(pos),
                                  "global", 0)
        got = port_attn._sdpa_dense(t(q), t(k), t(v), t(np.array(mask)),
                                    port_cfg, 0.2)
        want = ref_attn._sdpa_dense(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), mask, ref_cfg, 0.2)
    else:
        got = port_attn._sdpa_flash(t(q), t(k), t(v), t(pos), t(pos),
                                    "global", True, port_cfg, 0.2)
        want = ref_attn._sdpa_flash(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(pos),
                                    jnp.asarray(pos), "global", True,
                                    ref_cfg, 0.2)
    assert tuple(got.shape) == want.shape == (2, 20, 4, 16)
    close(got, want)


def test_mla_decode_past_the_cache_raises():
    ref_cfg, port_cfg = mla_cfgs(None, False)
    _, pp = mla_params(ref_cfg)
    cache = port_attn.init_mla_cache(port_cfg, 1, 4)
    x = torch.zeros((1, 1, 32))
    port_attn.apply_mla(pp, x, torch.tensor([[3]]), port_cfg, cache, 3)
    assert int(cache.pos[0, 3]) == 3
    with pytest.raises(ValueError, match="GEN_MARGIN"):
        port_attn.apply_mla(pp, x, torch.tensor([[4]]), port_cfg, cache, 4)
    with pytest.raises(ValueError, match="exceeds the MLA cache"):
        port_attn.apply_mla(pp, torch.zeros((1, 5, 32)),
                            torch.arange(5)[None], port_cfg,
                            port_attn.init_mla_cache(port_cfg, 1, 4))


# ---------------------------------------------------------------------------
# the whole decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_aux_matches_the_reference(arch):
    """The auxiliary loss summed over the MoE layers (deepseek-v2's dense
    first layer adds 0), at cf = 1.0 with drops."""
    pp = pair(arch, capacity_factor=1.0)
    toks = tokens(pp.port_cfg, 2, 24, seed=41)
    positions = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    _, _, want = jax.jit(pp.ref_task.model.forward)(
        pp.params, jnp.asarray(toks), jnp.asarray(positions))
    with torch.no_grad():
        _, _, got = pp.model.forward(torch.from_numpy(toks),
                                     torch.from_numpy(positions))
    assert got.dtype is torch.float32 and got.dim() == 0
    n_moe = sum(1 for b in pp.model.layers if not b.kind.endswith(":dense"))
    assert n_moe == (1 if arch == "deepseek-v2-236b" else 2)
    close(got, want, **ROUTE_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_with_drops_match_the_reference(arch,
                                                           monkeypatch):
    """cf = 1.0: a 24-token prefill of 2 sequences drops pairs (capacity
    12 an expert), and both packages drop the same ones; decode steps of
    2 tokens stay under the floor of 8 and keep every pair."""
    pp = pair(arch, capacity_factor=1.0)
    dropped = []
    real = port_moe._slots

    def counting(experts, cfg):
        out = real(experts, cfg)
        dropped.append(int((~out[2]).sum()))
        return out

    monkeypatch.setattr(port_moe, "_slots", counting)
    toks = tokens(pp.port_cfg, 2, 24 + 6, seed=42)
    n = 0
    for rl, pl in step_both(pp, toks, 24, 6, None):
        np.testing.assert_allclose(logits_np(pl), logits_np(rl), **LM_TOL)
        n += 1
    assert n == 7
    n_moe = len(dropped) // 7
    assert port_moe.capacity_of(48, pp.port_cfg) == 12
    assert sum(dropped[:n_moe]) > 0 and sum(dropped[n_moe:]) == 0
