"""The port's encoder-decoder (``repro_torch.models.encdec``,
``registry.EncDecTask``) against the reference's, at whisper-base's
``reduced()`` width on the CPU, the reference's parameters carried across
by ``convert.lm_params_from_reference``: the encoder output, prefill and
6 decode steps at rtol/atol 1e-4 (fp32), greedy ids exactly, bf16 at
``BF16_TOL``, the loss and its gradients, the cross attention over more
frames than ``_DENSE_MAX`` (the flash path), decode against the port's
own teacher-forced forward, and decode past ``GEN_MARGIN`` raising where
the reference overwrites its cache's last slot (ROADMAP.md queue 3).
The reference's own check of its decode is
``tests/test_serve_consistency.py``'s whisper case (16 frames, an 8-token
prompt); these use its shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import registry as ref_registry
from repro.serve import engine as ref_engine
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.models import attention as port_attention
from repro_torch.models import encdec as port_encdec
from repro_torch.models import registry as port_registry
from repro_torch.serve import engine as port_engine
from repro_torch.train import loop as port_loop

ARCH = "whisper-base"
# measured at most 9.5e-7 (the encoder output) and 2.1e-7 (prefill and
# decode logits) on these shapes
TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 activations: measured at most 4.5e-3 on logits up to 0.49 (16
# frames, an 8-token prompt, 6 decode steps, seeds 0-2)
BF16_TOL = dict(rtol=0, atol=2e-2)
# the loss and, relative to each gradient's largest entry, the
# gradients: measured 0 and 1.0e-6
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4
FRAMES, PROMPT, STEPS = 16, 8, 6

_PAIRS = {}


class Pair:
    """whisper-base in both packages: the reference task and its params,
    the port task and the same params carried across."""

    def __init__(self, **overrides):
        self.ref_cfg = ref_configs.get_config(ARCH, reduced=True)
        self.port_cfg = port_configs.get_config(ARCH, reduced=True)
        if overrides:
            self.ref_cfg = self.ref_cfg.reduced(**{
                k: (jnp.bfloat16 if v is torch.bfloat16 else v)
                for k, v in overrides.items()})
            self.port_cfg = self.port_cfg.reduced(**overrides)
        self.ref_task = ref_registry.make_task(self.ref_cfg)
        self.params = jax.jit(self.ref_task.init)(jax.random.PRNGKey(0))
        self.port_task = port_registry.make_task(self.port_cfg, "cpu")
        self.model = convert.lm_params_from_reference(
            jax.tree_util.tree_map(np.asarray, self.params), self.port_cfg,
            device="cpu")
        self.ref_prefill = jax.jit(self.ref_task.prefill)
        self.ref_decode = jax.jit(self.ref_task.decode_step)


def pair(**overrides):
    key = tuple(sorted(overrides.items(), key=str))
    if key not in _PAIRS:
        _PAIRS[key] = Pair(**overrides)
    return _PAIRS[key]


def inputs(cfg, B, L, seed=0, frames=FRAMES):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, frames, cfg.d_model)).astype(np.float32),
            r.integers(0, cfg.vocab_size, (B, L)).astype(np.int32))


def logits_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def step_both(pp, frames, toks, Lp, steps):
    """Prefill ``toks[:, :Lp]`` against ``frames``, then decode ``steps``
    tokens, in both packages; yields (reference logits, port logits)."""
    rc, rl = pp.ref_prefill(pp.params, {"frames": jnp.asarray(frames),
                                        "tokens": jnp.asarray(toks[:, :Lp])})
    pc, pl = pp.port_task.prefill(pp.model, {"frames": frames,
                                             "tokens": toks[:, :Lp]})
    yield rl, pl
    for t in range(steps):
        pos = Lp + t
        rl, rc = pp.ref_decode(pp.params, {
            "tokens": jnp.asarray(toks[:, pos:pos + 1]),
            "pos": jnp.asarray(pos, jnp.int32)}, rc)
        pl, pc = pp.port_task.decode_step(pp.model, {
            "tokens": toks[:, pos:pos + 1], "pos": pos}, pc)
        yield rl, pl


def test_task_and_model_structure():
    pp = pair()
    cfg = pp.port_cfg
    assert isinstance(pp.port_task, port_registry.EncDecTask)
    assert cfg.family == "audio" and cfg.encoder_decoder
    assert isinstance(pp.model, port_encdec.EncDecLM)
    assert (len(pp.model.enc), len(pp.model.dec)) == (
        cfg.n_encoder_layers, cfg.n_layers) == (2, 2)
    # every reference leaf, stacked over its layers, is one port tensor a
    # layer, with its values
    n_ref = sum(leaf.size for leaf in jax.tree_util.tree_leaves(pp.params))
    assert sum(p.numel() for p in pp.model.parameters()) == n_ref
    np.testing.assert_array_equal(
        pp.model.dec[1].cross_attn["wk"].numpy(),
        np.asarray(pp.params["dec"]["cross_attn"]["wk"][1]))
    np.testing.assert_array_equal(
        pp.model.enc[0].ln2["scale"].numpy(),
        np.asarray(pp.params["enc"]["ln2"]["scale"][0]))
    fresh = port_registry.make_task(cfg, "cpu").init(
        torch.Generator().manual_seed(0))
    assert {k: tuple(p.shape) for k, p in fresh.named_parameters()} == {
        k: tuple(p.shape) for k, p in pp.model.named_parameters()}
    assert all(not p.requires_grad for p in fresh.parameters())
    assert (fresh.enc[0].ln1["scale"] == 1).all()
    assert (fresh.enc[0].ln1["bias"] == 0).all()


def test_encoder_output_matches_the_reference():
    pp = pair()
    frames, _ = inputs(pp.port_cfg, 2, 1)
    want = jax.jit(pp.ref_task.model.encode)(pp.params, jnp.asarray(frames))
    with torch.no_grad():
        got = pp.model.encode(torch.from_numpy(frames))
    assert got.dtype is torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_match_the_reference():
    pp = pair()
    frames, toks = inputs(pp.port_cfg, 2, PROMPT + STEPS, seed=1)
    n = 0
    for rl, pl in step_both(pp, frames, toks, PROMPT, STEPS):
        assert tuple(pl.shape) == rl.shape == (2, 1, pp.port_cfg.vocab_size)
        np.testing.assert_allclose(logits_np(pl), logits_np(rl), **TOL)
        n += 1
    assert n == STEPS + 1


def test_cross_caches_match_the_reference():
    """Each layer's cross k/v, projected once at prefill, and the self-KV
    cache after it."""
    pp = pair()
    frames, toks = inputs(pp.port_cfg, 2, PROMPT, seed=2)
    rc, _ = pp.ref_prefill(pp.params, {"frames": jnp.asarray(frames),
                                       "tokens": jnp.asarray(toks)})
    pc, _ = pp.port_task.prefill(pp.model, {"frames": frames,
                                            "tokens": toks})
    assert len(pc) == pp.port_cfg.n_layers
    for i, layer in enumerate(pc):
        for field in ("k", "v", "pos"):
            for got, want in ((getattr(layer.cross_kv, field),
                               getattr(rc.cross_kv, field)[i]),
                              (getattr(layer.self_kv, field),
                               getattr(rc.self_kv, field)[i])):
                assert tuple(got.shape) == want.shape
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           **TOL)
    assert pc[0].self_kv.k.shape[1] == PROMPT + \
        port_registry.EncDecTask.GEN_MARGIN


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_ids_match_the_reference(seed):
    pp = pair()
    frames, prompts = inputs(pp.port_cfg, 2, PROMPT, seed=10 + seed)
    want = ref_engine.Engine(pp.ref_task, pp.params).generate(
        prompts, ref_engine.GenerateConfig(max_new_tokens=12),
        extra_batch={"frames": jnp.asarray(frames)})
    got = port_engine.Engine(pp.port_task, pp.model).generate(
        prompts, port_engine.GenerateConfig(max_new_tokens=12),
        extra_batch={"frames": torch.from_numpy(frames)})
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_activations_match_the_reference(seed):
    pp = pair(dtype=torch.bfloat16)
    assert pp.model.embed["table"].dtype is torch.float32     # param_dtype
    frames, toks = inputs(pp.port_cfg, 2, PROMPT + STEPS, seed=seed)
    for rl, pl in step_both(pp, frames, toks, PROMPT, STEPS):
        np.testing.assert_allclose(logits_np(pl), logits_np(rl), **BF16_TOL)


def _teacher_forced(pp, frames, toks):
    B, L = toks.shape
    positions = torch.arange(L, dtype=torch.int32)[None].expand(B, L)
    with torch.no_grad():
        memory = pp.model.encode(torch.from_numpy(frames))
        hidden, _ = pp.model.decode_stack(torch.from_numpy(toks), positions,
                                          memory)
        return pp.model.logits(hidden)


def test_decode_matches_its_teacher_forced_forward():
    pp = pair()
    frames, toks = inputs(pp.port_cfg, 2, PROMPT + STEPS, seed=4)
    want = _teacher_forced(pp, frames, toks)
    got = [pl for _, pl in step_both(pp, frames, toks, PROMPT, STEPS)]
    got = torch.cat(got, dim=1)
    np.testing.assert_allclose(got.numpy(),
                               want[:, PROMPT - 1:].numpy(), **TOL)


def test_cross_attention_over_many_frames_takes_the_flash_path(monkeypatch):
    """Full width cross-attends over 1,500 frames, past ``_DENSE_MAX``:
    with the dense limit and the blocks shrunk, the prefill's cross and
    encoder attention take the flash loop and still match the
    reference's dense prefill."""
    pp = pair()
    frames, toks = inputs(pp.port_cfg, 2, PROMPT + 2, seed=5, frames=37)
    monkeypatch.setattr(port_attention, "_DENSE_MAX", 8)
    monkeypatch.setattr(port_attention, "Q_BLOCK", 4)
    monkeypatch.setattr(port_attention, "KV_BLOCK", 8)
    calls = []
    flash = port_attention._sdpa_flash
    monkeypatch.setattr(port_attention, "_sdpa_flash",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    for rl, pl in step_both(pp, frames, toks, PROMPT, 2):
        np.testing.assert_allclose(logits_np(pl), logits_np(rl), **TOL)
    # the encoder's 2 layers and the prefill's 2 cross layers
    assert len(calls) == pp.port_cfg.n_encoder_layers + pp.port_cfg.n_layers


def test_generate_up_to_the_cache_margin_then_raise():
    """``GEN_MARGIN + 1`` new tokens give the reference's ids; one more
    decode step would write past the self-KV cache, where the reference
    clamps onto its last slot, and raises."""
    pp = pair()
    margin = port_registry.EncDecTask.GEN_MARGIN
    frames, prompts = inputs(pp.port_cfg, 1, 4, seed=6)
    want = ref_engine.Engine(pp.ref_task, pp.params).generate(
        prompts, ref_engine.GenerateConfig(max_new_tokens=margin + 1),
        extra_batch={"frames": jnp.asarray(frames)})
    eng = port_engine.Engine(pp.port_task, pp.model)
    got = eng.generate(prompts, port_engine.GenerateConfig(
        max_new_tokens=margin + 1),
        extra_batch={"frames": torch.from_numpy(frames)})
    np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="GEN_MARGIN"):
        eng.generate(prompts, port_engine.GenerateConfig(
            max_new_tokens=margin + 2),
            extra_batch={"frames": torch.from_numpy(frames)})


def test_loss_and_gradients_match_the_reference():
    """``EncDecTask.loss`` and its gradient against
    ``jax.value_and_grad(task.loss)``; the reference's gradient pytree
    comes across through the same converter as its parameters."""
    pp = pair()
    frames, toks = inputs(pp.port_cfg, 2, 24, seed=7)
    want, grads = jax.jit(jax.value_and_grad(pp.ref_task.loss))(
        pp.params, {"frames": jnp.asarray(frames),
                    "tokens": jnp.asarray(toks)})
    got, port_grads = port_loop.value_and_grad(
        pp.port_task, pp.model, {"frames": frames, "tokens": toks})
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    ref_grads = convert.lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, grads), pp.port_cfg, device="cpu")
    names = [k for k, _ in ref_grads.named_parameters()]
    assert sorted(names) == sorted(port_grads)
    for name, g in ref_grads.named_parameters():
        w = g.detach().numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(port_grads[name].numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


def test_remat_gives_the_same_gradients():
    """``cfg.remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``): the same loss and gradients, bitwise,
    as keeping the activations."""
    pp = pair()
    frames, toks = inputs(pp.port_cfg, 2, 12, seed=8)
    batch = {"frames": frames, "tokens": toks}
    assert pp.port_cfg.remat
    a, ga = port_loop.value_and_grad(pp.port_task, pp.model, batch)
    plain = port_registry.make_task(
        pp.port_cfg.reduced(remat=False), "cpu")
    model = convert.lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, pp.params), plain.cfg,
        device="cpu")
    b, gb = port_loop.value_and_grad(plain, model, batch)
    assert float(a) == float(b)
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name
