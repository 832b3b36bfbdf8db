"""The port's LM serving path (``repro_torch.models``, ``serve.engine``,
``launch.serve``) against the reference's for the dense, vlm and moe
families, at ``reduced()`` width on the CPU, the reference's parameters carried across by
``convert.lm_params_from_reference``.

Prefill and decode logits agree with the reference's at rtol/atol 1e-4
(fp32); greedy ids agree exactly.  The port's decode also equals its own
teacher-forced forward, including a local layer whose prompt passes the
window (where the reference's ring does not: ROADMAP.md queue 3), and
decode past the cache's headroom raises where the reference overwrites
its last slot."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import registry as ref_registry
from repro.serve import engine as ref_engine
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import registry as port_registry
from repro_torch.serve import engine as port_engine

PORTED = ["smollm-135m", "gemma2-2b", "gemma2-9b", "qwen3-4b",
          "llava-next-mistral-7b", "deepseek-v2-236b", "qwen2-moe-a2.7b"]
# the ROADMAP item of each arch outside item 16a; 16b's are ported
ITEM = {"deepseek-v2-236b": "16b", "qwen2-moe-a2.7b": "16b",
        "mamba2-130m": "16c", "recurrentgemma-9b": "16c",
        "whisper-base": "16d"}
NOT_PORTED = {arch: item for arch, item in ITEM.items()
              if arch not in PORTED}
TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 activations: XLA and torch round some bf16 products differently.
# Measured on these reduced configs (prompt 8, 6 decode steps, seeds 3-5):
# at most 7.7e-3 (gemma2-2b) and 6.3e-3 (qwen3-4b) on logits up to 0.67.
BF16_TOL = dict(rtol=0, atol=2e-2)
TIE_GAP = 1e-4      # a reference top-2 gap under this is a tie for ids

_PAIRS = {}


class Pair:
    """One arch in both packages: the reference task and its params, the
    port task and the same params carried across."""

    def __init__(self, arch, **overrides):
        self.ref_cfg = ref_configs.get_config(arch, reduced=True)
        self.port_cfg = port_configs.get_config(arch, reduced=True)
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

    def patch(self, B, seed=1):
        """Numpy patch embeddings for a vlm config (else None)."""
        n = self.port_cfg.vision_tokens
        if not n:
            return None
        r = np.random.default_rng(seed)
        return (r.normal(size=(B, n, self.port_cfg.d_model)) * 0.02).astype(
            np.float32)


def pair(arch, **overrides):
    key = (arch, tuple(sorted(overrides.items(), key=str)))
    if key not in _PAIRS:
        _PAIRS[key] = Pair(arch, **overrides)
    return _PAIRS[key]


def tokens(cfg, B, L, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


def logits_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def step_both(pp, toks, Lp, steps, patch):
    """Prefill ``toks[:, :Lp]`` then decode ``steps`` tokens in both
    packages; yields (reference logits, port logits) for each call."""
    n_vis = pp.port_cfg.vision_tokens
    rb = {"tokens": jnp.asarray(toks[:, :Lp])}
    pb = {"tokens": toks[:, :Lp]}
    if patch is not None:
        rb["patch_embeds"] = jnp.asarray(patch)
        pb["patch_embeds"] = torch.from_numpy(patch)
    rc, rl = pp.ref_prefill(pp.params, rb)
    pc, pl = pp.port_task.prefill(pp.model, pb)
    yield rl, pl
    for t in range(steps):
        pos = Lp + t + n_vis
        rl, rc = pp.ref_decode(pp.params, {
            "tokens": jnp.asarray(toks[:, Lp + t:Lp + t + 1]),
            "pos": jnp.asarray(pos, jnp.int32)}, rc)
        pl, pc = pp.port_task.decode_step(pp.model, {
            "tokens": toks[:, Lp + t:Lp + t + 1], "pos": pos}, pc)
        yield rl, pl


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_the_reference(arch):
    pp = pair(arch)
    toks = tokens(pp.port_cfg, 2, 8 + 6)
    n = 0
    for rl, pl in step_both(pp, toks, 8, 6, pp.patch(2)):
        assert tuple(pl.shape) == rl.shape == (2, 1, pp.port_cfg.vocab_size)
        assert pl.dtype is torch.float32
        np.testing.assert_allclose(logits_np(pl), logits_np(rl), **TOL)
        n += 1
    assert n == 7


def test_a_trailing_partial_segment_maps_to_the_last_layers():
    """5 layers of (local, global) are two segments in the reference (2
    repeats, then one local layer): the converter unstacks both in
    order."""
    pp = pair("gemma2-2b", n_layers=5)
    assert pp.ref_cfg.segments == ((("local", "global"), 2), (("local",), 1))
    assert [b.kind for b in pp.model.layers] == ["local", "global"] * 2 + [
        "local"]
    toks = tokens(pp.port_cfg, 2, 8 + 3, seed=5)
    for rl, pl in step_both(pp, toks, 8, 3, None):
        np.testing.assert_allclose(logits_np(pl), logits_np(rl), **TOL)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-4b"])
def test_bf16_activations_match_the_reference(arch):
    pp = pair(arch, dtype=torch.bfloat16)
    assert pp.model.embed["table"].dtype is torch.float32     # param_dtype
    toks = tokens(pp.port_cfg, 2, 8 + 6, seed=3)
    for rl, pl in step_both(pp, toks, 8, 6, None):
        np.testing.assert_allclose(logits_np(pl), logits_np(rl), **BF16_TOL)


def _teacher_forced(pp, full, patch):
    """The port's full forward over ``full``: logits at every text
    position."""
    n_vis = pp.port_cfg.vision_tokens
    B, L = full.shape
    positions = torch.arange(L + n_vis)[None].expand(B, -1)
    with torch.no_grad():
        hidden, _, _ = pp.model.forward(
            torch.from_numpy(full), positions,
            patch_embeds=None if patch is None else torch.from_numpy(patch))
        return pp.model.logits(hidden[:, n_vis:]).numpy()


@pytest.mark.parametrize("arch,Lp", [(a, 8) for a in PORTED] + [
    ("gemma2-2b", 20), ("gemma2-2b", 37)])
def test_decode_matches_its_teacher_forced_forward(arch, Lp):
    """Prefill + decode equals the full forward at every step; at 20 and
    37 prompt tokens gemma2's local layers (window 16) hold a ring that
    has wrapped (the reference's decode is off by 0.1–0.5 there)."""
    pp = pair(arch)
    steps = 6
    toks = tokens(pp.port_cfg, 2, Lp + steps, seed=Lp)
    patch = pp.patch(2)
    want = _teacher_forced(pp, toks, patch)
    for t, (_, pl) in enumerate(step_both(pp, toks, Lp, steps, patch)):
        np.testing.assert_allclose(logits_np(pl)[:, 0], want[:, Lp - 1 + t],
                                   rtol=1e-5, atol=1e-5)


def _ref_generate(pp, prompts, n, patch=None, **kw):
    eng = ref_engine.Engine(pp.ref_task, pp.params)
    extra = None if patch is None else {"patch_embeds": jnp.asarray(patch)}
    return eng.generate(prompts, ref_engine.GenerateConfig(
        max_new_tokens=n, **kw), extra_batch=extra)


def _port_generate(pp, prompts, n, patch=None, **kw):
    eng = port_engine.Engine(pp.port_task, pp.model)
    extra = None if patch is None else {
        "patch_embeds": torch.from_numpy(patch)}
    return eng.generate(prompts, port_engine.GenerateConfig(
        max_new_tokens=n, **kw), extra_batch=extra)


def _first_tie(pp, prompts, ids, patch):
    """The first step whose reference top-2 gap (along the reference's own
    ids) is under ``TIE_GAP``, or None."""
    full = np.concatenate([prompts, ids], axis=1)
    n_vis = pp.ref_cfg.vision_tokens
    B, L = full.shape
    positions = jnp.broadcast_to(jnp.arange(L + n_vis)[None], (B, L + n_vis))
    hidden, _, _ = jax.jit(pp.ref_task.model.forward)(
        pp.params, jnp.asarray(full), positions,
        None if patch is None else jnp.asarray(patch))
    logits = np.asarray(pp.ref_task.model.logits(pp.params, hidden[:, n_vis:]))
    Lp = prompts.shape[1]
    top2 = np.sort(logits[:, Lp - 1:L - 1], axis=-1)[..., -2:]
    gaps = (top2[..., 1] - top2[..., 0]).min(axis=0)
    ties = np.flatnonzero(gaps < TIE_GAP)
    return (int(ties[0]) if ties.size else None), logits


@pytest.mark.parametrize("arch", PORTED)
def test_greedy_generate_matches_the_reference(arch):
    pp = pair(arch)
    prompts = tokens(pp.port_cfg, 2, 5, seed=7)
    patch = pp.patch(2, seed=8)
    want = _ref_generate(pp, prompts, 10, patch)
    got = _port_generate(pp, prompts, 10, patch)
    assert got.dtype == np.int32 and got.shape == want.shape == (2, 10)
    tie, ref_logits = _first_tie(pp, prompts, want, patch)
    if tie is None:
        np.testing.assert_array_equal(got, want)
        return
    print(f"{arch}: the reference's top-2 gap is under {TIE_GAP} at step "
          f"{tie}: ids compared before it, logits at it")
    np.testing.assert_array_equal(got[:, :tie], want[:, :tie])
    port_logits = _teacher_forced(pp, np.concatenate([prompts, want], 1),
                                  patch)
    Lp = prompts.shape[1]
    np.testing.assert_allclose(port_logits[:, Lp - 1 + tie],
                               ref_logits[:, Lp - 1 + tie], **TOL)


def test_generate_up_to_the_cache_margin():
    """GEN_MARGIN + 1 = 65 new tokens are the reference's ids; 66 raises
    where the reference's 65th decode step overwrites its last slot."""
    pp = pair("smollm-135m")
    margin = port_registry.DecoderTask.GEN_MARGIN
    assert margin == ref_registry.DecoderTask.GEN_MARGIN == 64
    prompts = tokens(pp.port_cfg, 2, 5, seed=11)
    want = _ref_generate(pp, prompts, margin + 1)
    got = _port_generate(pp, prompts, margin + 1)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="GEN_MARGIN"):
        _port_generate(pp, prompts, margin + 2)


def test_eos_pads_as_the_reference_does():
    pp = pair("qwen3-4b")
    prompts = tokens(pp.port_cfg, 2, 6, seed=12)
    free = _ref_generate(pp, prompts, 8)
    eos = int(free[0, 2])
    want = _ref_generate(pp, prompts, 8, eos_id=eos, pad_id=255)
    got = _port_generate(pp, prompts, 8, eos_id=eos, pad_id=255)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 3:] == 255).all()


def test_temperature_sampling_is_seeded():
    """Draws come from the port's own generator (the reference's
    ``jax.random`` draws differ; ROADMAP.md queue 3): valid ids, the same
    for one seed."""
    pp = pair("smollm-135m")
    prompts = tokens(pp.port_cfg, 3, 5, seed=13)
    a = _port_generate(pp, prompts, 12, temperature=1.5, seed=4)
    b = _port_generate(pp, prompts, 12, temperature=1.5, seed=4)
    c = _port_generate(pp, prompts, 12, temperature=1.5, seed=5)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < pp.port_cfg.vocab_size)).all()
    assert not np.array_equal(a, c)
    assert not np.array_equal(a, _port_generate(pp, prompts, 12))


@pytest.mark.parametrize("arch", sorted(ITEM))
def test_other_archs_name_their_item(arch, capsys):
    """Archs outside item 16a: a ported one (16b's MoE and MLA archs)
    builds its task and serves from the reduced launcher; the others raise,
    naming their item."""
    cfg = port_configs.get_config(arch, reduced=True)
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "6", "--max-new", "10", "--device", "cpu"]
    if arch in PORTED:
        task = port_registry.make_task(cfg, "cpu")
        assert isinstance(task, port_registry.DecoderTask)
        assert task.cfg.moe and task.cfg.family == "moe"
        out = port_serve.main(argv)
        n, ids = _lines(capsys.readouterr().out)
        assert (n, len(ids)) == (20, 10) and out.shape == (2, 10)
        assert ids == out[0].tolist()
        assert ((out >= 0) & (out < cfg.vocab_size)).all()
        return
    with pytest.raises(NotImplementedError, match=f"item {ITEM[arch]}"):
        port_registry.make_task(cfg, "cpu")
    with pytest.raises(NotImplementedError, match=f"item {ITEM[arch]}"):
        port_serve.main(argv)


def test_task_training_and_specs_name_their_items():
    task = port_registry.make_task(
        port_configs.get_config("smollm-135m", reduced=True), "cpu")
    with pytest.raises(NotImplementedError, match="item 16e"):
        task.loss(None, {})
    with pytest.raises(NotImplementedError, match="item 16f"):
        task.input_specs("train_4k")
    with pytest.raises(NotImplementedError, match="item 16e"):
        port_train.main(["--arch", "qwen3-4b", "--reduced"])


LINE1 = re.compile(r"^generated (\d+) tokens in \d+\.\d\ds "
                   r"\(\d+\.\d tok/s incl\. compile\)$")
LINE2 = re.compile(r"^first sequence: \[(\d+(, \d+)*)\]$")


def _lines(out):
    lines = out.strip().splitlines()
    assert len(lines) == 2, lines
    m1, m2 = LINE1.match(lines[0]), LINE2.match(lines[1])
    assert m1 and m2, lines
    return int(m1.group(1)), [int(t) for t in m2.group(1).split(", ")]


@pytest.mark.parametrize("arch", ["qwen3-4b", "llava-next-mistral-7b",
                                  "deepseek-v2-236b", "qwen2-moe-a2.7b"])
def test_launcher_prints_the_reference_lines(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--batch", "3", "--prompt-len", "6",
            "--max-new", "20"]
    ref_serve.main(argv)
    ref_n, ref_ids = _lines(capsys.readouterr().out)
    out = port_serve.main(argv + ["--device", "cpu"])
    n, ids = _lines(capsys.readouterr().out)
    assert (n, len(ids)) == (ref_n, len(ref_ids)) == (60, 16)
    assert out.shape == (3, 20) and ids == out[0, :16].tolist()
    again = port_serve.main(argv + ["--device", "cpu"])
    assert _lines(capsys.readouterr().out)[1] == ids
    np.testing.assert_array_equal(again, out)
