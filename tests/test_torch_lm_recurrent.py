"""The port's recurrent mixers (``repro_torch.models.ssm``, Mamba-2's SSD
layer, and ``repro_torch.models.rglru``, Griffin's RG-LRU block) against
the reference's on the same numpy inputs, at ``reduced()`` width in fp32
(SSM chunk 8, conv kernel 4): init (keys, shapes, the constant leaves),
each mixer without a cache, as a prefill then 6 decode steps, and from a
nonzero state, outputs and every cache field at rtol/atol 1e-5, and
``ssd_chunked`` with and without an initial state.  The whole models are
in ``tests/test_torch_lm_serve.py``; the scan helper is in
``tests/test_torch_lm_layers.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro_torch import configs as port_configs
from repro_torch.models import common as port_common
from repro_torch.models import rglru as port_rglru
from repro_torch.models import ssm as port_ssm

# measured at most 2.6e-6 (the SSM from a nonzero state), 1.1e-6 (the
# RG-LRU) and 2.9e-6 (``ssd_chunked`` on unit-normal inputs), outputs and
# cache fields alike
TOL = dict(rtol=1e-5, atol=1e-5)
# the constant leaves (A_log, D and the zeros): measured 0
CONST_TOL = dict(rtol=1e-6, atol=1e-6)
# lam = log(expm1(-log(x) / c)) at x = linspace(0.9, 0.999): torch's fp32
# linspace rounds some x one ulp away from XLA's fused form, and near x =
# 0.999 lam moves ~1000 times as far as x, so lam is held relatively:
# measured 1.2e-6 (reduced width) and 6.5e-6 (4,096 channels; 5.8e-5
# absolute on values of -4.3 to -9.0)
LAM_TOL = dict(rtol=1e-5, atol=0)

# one compile a shape instead of one a primitive: eager JAX is slow here
ref_apply = {
    "ssm": jax.jit(ref_ssm.apply_ssm, static_argnames=("cfg", "decode")),
    "rec": jax.jit(ref_rglru.apply_rglru, static_argnames=("cfg", "decode")),
}
ref_ssd = jax.jit(ref_ssm.ssd_chunked, static_argnames=("chunk",))

# mixer case -> (arch, config overrides); "rec-w24": rglru_width=24, where
# the 16 gate blocks do not divide the width and halve to 8
CASES = {"ssm": ("mamba2-130m", {}), "rec": ("recurrentgemma-9b", {}),
         "rec-w24": ("recurrentgemma-9b", {"rglru_width": 24})}


def rng(seed=0):
    return np.random.default_rng(seed)


def normal(r, *shape):
    return r.normal(size=shape).astype(np.float32)


def close(got, want, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def to_port(p):
    return torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(np.array(v, np.float32)),
                               requires_grad=False) for k, v in p.items()})


class Mixer:
    """One mixer case in both packages: configs, the reference's params
    with its zero and constant leaves perturbed (so each shows), the same
    params in the port, and each package's init, cache and apply."""

    def __init__(self, case, seed=0):
        arch, overrides = CASES[case]
        self.kind = case.split("-")[0]
        self.ref_cfg = ref_configs.get_config(arch, reduced=True).reduced(
            **overrides)
        self.port_cfg = port_configs.get_config(arch, reduced=True).reduced(
            **overrides)
        if self.kind == "ssm":
            ref_init, self.ref_cache = ref_ssm.init_ssm, ref_ssm.init_ssm_cache
            self.port_cache, self.port_apply = port_ssm.init_ssm_cache, \
                port_ssm.apply_ssm
        else:
            ref_init, self.ref_cache = ref_rglru.init_rglru, \
                ref_rglru.init_rglru_cache
            self.port_cache, self.port_apply = port_rglru.init_rglru_cache, \
                port_rglru.apply_rglru
        p = dict(jax.jit(ref_init, static_argnums=1)(
            jax.random.PRNGKey(seed), self.ref_cfg))
        r = rng(seed + 100)
        for k in ("conv_b", "dt_bias", "norm", "D", "b_a", "b_x"):
            if k in p:
                p[k] = p[k] + jnp.asarray(normal(r, *p[k].shape)) * 0.3
        self.p, self.pp = p, to_port(p)

    def apply_both(self, x, ref_cache=None, port_cache=None, decode=False):
        want, wc = ref_apply[self.kind](self.p, jnp.asarray(x), self.ref_cfg,
                                        cache=ref_cache, decode=decode)
        got, gc = self.port_apply(self.pp, torch.from_numpy(x),
                                  self.port_cfg, cache=port_cache,
                                  decode=decode)
        close(got, want)
        if wc is None:
            assert gc is None
        else:
            assert type(gc)._fields == type(wc)._fields
            for g, w in zip(gc, wc):
                assert g.dtype is torch.float32 and tuple(g.shape) == w.shape
                close(g, w)
        return wc, gc


_MIXERS = {}


def mixer(case):
    if case not in _MIXERS:
        _MIXERS[case] = Mixer(case)
    return _MIXERS[case]


def _caches(mx, B, seed=None):
    """Both packages' fresh caches, or, with ``seed``, the same random
    state and conv rows in each."""
    ref_c = mx.ref_cache(mx.ref_cfg, B)
    if seed is not None:
        r = rng(seed)
        ref_c = type(ref_c)(*(jnp.asarray(normal(r, *a.shape)) * 0.5
                              for a in ref_c))
    port_c = type(mx.port_cache(mx.port_cfg, B))(
        *(torch.from_numpy(np.array(a)) for a in ref_c))
    return ref_c, port_c


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ssm", "rec", "rec-w24", "rec-full",
                                  "ssm-full"])
def test_init_matches_the_reference(case):
    """The reference's keys, shapes and dtypes; the constant leaves
    (``A_log``, ``D`` and the zeros) equal within 1e-6 and ``lam`` within
    1e-5 relative, at reduced and at published width (uninitialised draws
    there)."""
    full = case.endswith("-full")
    arch = {"ssm": "mamba2-130m", "rec": "recurrentgemma-9b"}[
        case.split("-")[0]]
    if full:
        ref_cfg = ref_configs.get_config(arch)
        port_cfg = port_configs.get_config(arch)
    else:
        mx = mixer(case)
        ref_cfg, port_cfg = mx.ref_cfg, mx.port_cfg
    ref_init = ref_ssm.init_ssm if case.startswith("ssm") else \
        ref_rglru.init_rglru
    port_init = port_ssm.init_ssm if case.startswith("ssm") else \
        port_rglru.init_rglru
    want = jax.jit(ref_init, static_argnums=1)(jax.random.PRNGKey(1),
                                               ref_cfg)
    got = port_init(None if full else torch.Generator().manual_seed(0),
                    port_cfg, device="cpu")
    assert sorted(got) == sorted(want)
    drawn = {"in_proj", "conv_w", "out_proj", "w_rec_in", "w_gate_in",
             "w_a", "w_x", "w_out"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype is torch.float32 and not got[k].requires_grad
        if k not in drawn:
            close(got[k], want[k], **(LAM_TOL if k == "lam" else CONST_TOL))
    if not full:
        # drawn leaves: truncated at 2 standard deviations of 1/sqrt(fan-in)
        for k in drawn & set(want):
            fan_in = want[k].shape[-2]
            assert float(got[k].abs().max()) <= 2.0 / fan_in ** 0.5 + 1e-6


@pytest.mark.parametrize("width,blocks", [(4096, 16), (32, 16), (24, 8),
                                          (6, 2), (7, 1)])
def test_gate_blocks(width, blocks):
    """16 blocks halve until they divide the width (full width: 16 of
    256; reduced: 16 of 2)."""
    ref_cfg = ref_configs.get_config("recurrentgemma-9b").reduced(
        rglru_width=width)
    port_cfg = port_configs.get_config("recurrentgemma-9b").reduced(
        rglru_width=width)
    assert port_rglru._gate_blocks(port_cfg) == \
        ref_rglru._gate_blocks(ref_cfg) == blocks


def test_caches_match_the_reference():
    for case in ("ssm", "rec"):
        mx = mixer(case)
        want = mx.ref_cache(mx.ref_cfg, 3)
        got = mx.port_cache(mx.port_cfg, 3)
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and w.dtype == jnp.float32
            assert g.dtype is torch.float32 and not g.any()


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [2, 8, 13])
@pytest.mark.parametrize("case", list(CASES))
def test_mixer_without_cache(case, L):
    mx = mixer(case)
    mx.apply_both(normal(rng(L), 2, L, mx.port_cfg.d_model))


@pytest.mark.parametrize("L", [2, 8, 13])
@pytest.mark.parametrize("case", list(CASES))
def test_mixer_prefill_then_decode(case, L):
    """A prompt shorter than the conv window (2), one chunk (8) and one
    that is not a multiple of the chunk (13), then 6 decode steps: every
    output, state and conv row within 1e-5."""
    mx = mixer(case)
    B, steps = 2, 6
    x = normal(rng(20 + L), B, L + steps, mx.port_cfg.d_model)
    ref_c, port_c = _caches(mx, B)
    ref_c, port_c = mx.apply_both(x[:, :L], ref_c, port_c)
    for t in range(L, L + steps):
        ref_c, port_c = mx.apply_both(x[:, t:t + 1], ref_c, port_c,
                                      decode=True)


@pytest.mark.parametrize("L", [2, 13])
@pytest.mark.parametrize("case", list(CASES))
def test_mixer_from_a_nonzero_state(case, L):
    """A prefill into a cache holding a nonzero state (the SSD scan's and
    the RG-LRU scan's initial state) and nonzero conv rows (kept where
    the prompt is shorter than K - 1), then decode."""
    mx = mixer(case)
    B = 2
    x = normal(rng(30 + L), B, L + 2, mx.port_cfg.d_model)
    ref_c, port_c = _caches(mx, B, seed=31)
    ref_c, port_c = mx.apply_both(x[:, :L], ref_c, port_c)
    for t in range(L, L + 2):
        ref_c, port_c = mx.apply_both(x[:, t:t + 1], ref_c, port_c,
                                      decode=True)


@pytest.mark.parametrize("initial", [False, True])
def test_ssd_chunked(initial):
    """Three chunks of 8, with and without an initial state."""
    B, L, H, P, N, Q = 2, 24, 3, 4, 5, 8
    r = rng(40)
    x, Bm, Cm = normal(r, B, L, H, P), normal(r, B, L, H, N), \
        normal(r, B, L, H, N)
    a = -np.abs(normal(r, B, L, H)) * 0.3
    s0 = normal(r, B, H, P, N) if initial else None
    want_y, want_s = ref_ssd(jnp.asarray(x), jnp.asarray(a), jnp.asarray(Bm),
                             jnp.asarray(Cm), Q,
                             None if s0 is None else jnp.asarray(s0))
    t = torch.from_numpy
    got_y, got_s = port_ssm.ssd_chunked(t(x), t(a), t(Bm), t(Cm), Q,
                                        None if s0 is None else t(s0))
    close(got_y, want_y)
    close(got_s, want_s)


def test_segsum_and_causal_conv():
    r = rng(41)
    a = normal(r, 2, 3, 7)
    got = port_ssm._segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(ref_ssm._segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    close(np.where(np.isinf(got), 0, got), np.where(np.isinf(want), 0, want))
    x, w, b = normal(r, 2, 9, 6), normal(r, 4, 6), normal(r, 6)
    t = torch.from_numpy
    close(port_ssm._causal_conv(t(x), t(w), t(b)),
          ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b)))
    close(port_common.causal_conv(t(x), t(w)) + t(b),
          ref_rglru._conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


def test_rglru_gates():
    mx = mixer("rec")
    u = normal(rng(42), 2, 5, mx.port_cfg.d_rnn)
    got = port_rglru._gates(mx.pp, torch.from_numpy(u), mx.port_cfg)
    want = ref_rglru._gates(mx.p, jnp.asarray(u), mx.ref_cfg)
    for g, w in zip(got, want):
        close(g, w)
