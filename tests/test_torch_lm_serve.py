"""The port's LM serving path (``repro_torch.models``, ``serve.engine``,
``launch.serve``) against the reference's for the dense, vlm, moe, ssm
and hybrid families, at ``reduced()`` width on the CPU, the reference's
parameters carried across by ``convert.lm_params_from_reference``.

Prefill and decode logits agree with the reference's at rtol/atol 1e-4
(fp32); greedy ids agree exactly.  The port's decode also equals its own
teacher-forced forward, including a local layer whose prompt passes the
window (where the reference's ring does not: ROADMAP.md queue 3), and
decode past the cache's headroom raises where the reference overwrites
its last slot; the recurrent archs (mamba2's SSD state, recurrentgemma's
RG-LRU state and local rings) have no such limit in either package."""
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
          "llava-next-mistral-7b", "deepseek-v2-236b", "qwen2-moe-a2.7b",
          "mamba2-130m", "recurrentgemma-9b"]
RECURRENT = ["mamba2-130m", "recurrentgemma-9b"]
# the ROADMAP item of each arch outside item 16a; 16b's and 16c's are
# ported
ITEM = {"deepseek-v2-236b": "16b", "qwen2-moe-a2.7b": "16b",
        "mamba2-130m": "16c", "recurrentgemma-9b": "16c",
        "whisper-base": "16d"}
# the family and the mixers of each ported arch outside item 16a
FAMILY = {"deepseek-v2-236b": ("moe", {"global"}),
          "qwen2-moe-a2.7b": ("moe", {"global"}),
          "mamba2-130m": ("ssm", {"ssm"}),
          "recurrentgemma-9b": ("hybrid", {"rec", "local"})}
NOT_PORTED = {arch: item for arch, item in ITEM.items()
              if arch not in PORTED}
TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 activations: XLA and torch round some bf16 products differently.
# Measured on these reduced configs (prompt 8, 6 decode steps, seeds 3-5):
# at most 7.7e-3 (gemma2-2b) and 6.3e-3 (qwen3-4b) on logits up to 0.67.
BF16_TOL = dict(rtol=0, atol=2e-2)
# the recurrent archs, where XLA also keeps the conv's and the gates'
# fused bf16 chains in fp32: measured on these reduced configs (prompts 8,
# 13 and 16, 6 decode steps, seeds 3-5) at most 1.6e-2 (mamba2-130m) and
# 2.9e-2 (recurrentgemma-9b, prompt 13) on logits up to 0.58; the
# reference's own bf16 decode against its forward reaches 1.4e-2
RECURRENT_BF16_TOL = dict(rtol=0, atol=4e-2)
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


def test_a_trailing_rec_segment_maps_to_the_last_layers():
    """recurrentgemma's 8 layers are two segments in the reference (2
    repeats of (rec, rec, local), then (rec, rec)), as its 38 are (12
    repeats, then the port's layers 36 and 37): the converter unstacks
    both in order, block-diagonal gates included."""
    pp = pair("recurrentgemma-9b", n_layers=8)
    assert pp.ref_cfg.segments == ((("rec", "rec", "local"), 2),
                                   (("rec", "rec"), 1))
    assert [b.kind for b in pp.model.layers] == ["rec", "rec", "local"] * 2 \
        + ["rec", "rec"]
    for i, layer in enumerate(pp.model.layers[6:]):
        want = jax.tree_util.tree_map(np.asarray, pp.params["seg1"][i])
        for key, val in want["mixer"].items():
            np.testing.assert_array_equal(layer.mixer[key].numpy(), val[0])
        np.testing.assert_array_equal(layer.ffn["wi"].numpy(),
                                      want["ffn"]["wi"][0])
    assert tuple(pp.model.layers[7].mixer["w_a"].shape) == (16, 2, 2)
    toks = tokens(pp.port_cfg, 2, 13 + 6, seed=6)
    for rl, pl in step_both(pp, toks, 13, 6, None):
        np.testing.assert_allclose(logits_np(pl), logits_np(rl), **TOL)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-4b"] + RECURRENT)
def test_bf16_activations_match_the_reference(arch):
    pp = pair(arch, dtype=torch.bfloat16)
    assert pp.model.embed["table"].dtype is torch.float32     # param_dtype
    tol = RECURRENT_BF16_TOL if arch in RECURRENT else BF16_TOL
    toks = tokens(pp.port_cfg, 2, 8 + 6, seed=3)
    for rl, pl in step_both(pp, toks, 8, 6, None):
        np.testing.assert_allclose(logits_np(pl), logits_np(rl), **tol)


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
    ("gemma2-2b", 20), ("gemma2-2b", 37), ("recurrentgemma-9b", 20),
    ("recurrentgemma-9b", 37), ("mamba2-130m", 37)])
def test_decode_matches_its_teacher_forced_forward(arch, Lp):
    """Prefill + decode equals the full forward at every step; at 20 and
    37 prompt tokens gemma2's and recurrentgemma's local layers (window
    16) hold a ring that has wrapped (the reference's decode is off by
    0.1–0.5 there), and mamba2's 37 tokens fill 5 chunks of 8, the last
    one padded."""
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
    _assert_the_reference_ids(pp, prompts, got, want, patch)


def _assert_the_reference_ids(pp, prompts, got, want, patch=None):
    """``got`` equals the reference's greedy ``want``; where the
    reference's top-2 gap falls under ``TIE_GAP``, up to that step, and
    the port's logits at it within ``TOL``."""
    tie, ref_logits = _first_tie(pp, prompts, want, patch)
    if tie is None:
        np.testing.assert_array_equal(got, want)
        return
    print(f"{pp.port_cfg.name}: the reference's top-2 gap is under "
          f"{TIE_GAP} at step {tie}: ids compared before it, logits at it")
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


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_archs_generate_past_the_cache_margin(arch):
    """100 new tokens, past ``GEN_MARGIN``: the recurrent state has no
    slots and recurrentgemma's local layers are full rings (a 5-token
    prompt, inside the window), so neither package has a limit here and
    the ids are the reference's."""
    pp = pair(arch)
    prompts = tokens(pp.port_cfg, 2, 5, seed=14)
    n = 100
    assert n > port_registry.DecoderTask.GEN_MARGIN + 1
    want = _ref_generate(pp, prompts, n)
    got = _port_generate(pp, prompts, n)
    assert got.shape == want.shape == (2, n)
    _assert_the_reference_ids(pp, prompts, got, want)


def test_recurrentgemma_decodes_past_a_short_local_cache():
    """At a window of 96 a 5-token prompt's local caches hold 5 +
    ``GEN_MARGIN`` = 69 slots (recurrentgemma at full width: any prompt
    under 1,984 tokens): 100 decode steps grow them into the 96-slot
    ring and wrap it, each step equal to the port's teacher-forced
    forward."""
    cfg = port_configs.get_config("recurrentgemma-9b",
                                  reduced=True).reduced(window=96)
    task = port_registry.make_task(cfg, "cpu")
    model = task.init(torch.Generator().manual_seed(0))
    toks = tokens(cfg, 2, 5 + 100, seed=15)
    with torch.no_grad():
        hidden, _, _ = model.forward(torch.from_numpy(toks),
                                     torch.arange(105)[None].expand(2, -1))
        want = model.logits(hidden).numpy()
    caches, logits = task.prefill(model, {"tokens": toks[:, :5]})
    assert caches[2].k.shape[1] == 69
    for t in range(100):
        np.testing.assert_allclose(logits_np(logits)[:, 0], want[:, 4 + t],
                                   rtol=1e-5, atol=1e-5)
        logits, caches = task.decode_step(model, {
            "tokens": toks[:, 5 + t:6 + t], "pos": 5 + t}, caches)
    assert caches[2].k.shape[1] == 96


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
    """Archs outside item 16a: a ported one (16b's MoE and MLA archs,
    16c's SSM and RG-LRU archs) builds its task, of its own family, and
    serves from the reduced launcher; the others raise, naming their
    item."""
    cfg = port_configs.get_config(arch, reduced=True)
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "6", "--max-new", "10", "--device", "cpu"]
    if arch in PORTED:
        task = port_registry.make_task(cfg, "cpu")
        assert isinstance(task, port_registry.DecoderTask)
        family, mixers = FAMILY[arch]
        assert task.cfg.family == family and set(cfg.pattern) == mixers
        assert task.cfg.moe == (family == "moe")
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
                                  "deepseek-v2-236b", "qwen2-moe-a2.7b"]
                         + RECURRENT)
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
