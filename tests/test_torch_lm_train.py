"""The port's LM training substrate against the reference's, on the CPU:
the token pipeline (``data/tokens.py``, batches equal exactly), the
losses (``train/losses.py``: chunked against full cross entropy and
against the reference's, gradients too, and the chunked loss keeping no
(N, V) logits for the backward), the optimizers (``train/optimizer.py``:
``lr_at`` and ``clip_by_global_norm`` at 1e-7 relative, 1e-6 on a large
tree, one ``apply`` of each optimizer on identical parameters and
gradients at 1e-6), the
optimizer half of ``train/checkpoint.py`` (across the packages both
ways), and the port's own contracts of ``train/loop.Trainer`` and
``train/ft.py`` (the reference's ``tests/test_fault_tolerance.py``
mirrored: resume reproduces the uninterrupted run, ``run_with_recovery``
restarts once on an injected failure, the loss falls on the Markov
stream), and whole steps of ``make_train_step`` against the reference's
(3 ``sgd`` steps at 1e-5; ``microbatches=2`` against the reference's and
against one microbatch).  The whole models' losses and gradients are in
``tests/test_torch_lm_grads.py``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import tokens as ref_tokens
from repro.train import checkpoint as ref_ckpt
from repro.train import loop as ref_loop
from repro.train import losses as ref_losses
from repro.train import optimizer as ref_opt
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch import kg as port_kg
from repro_torch.data import kg as port_kg_lib
from repro_torch.data import tokens as port_tokens
from repro_torch.models import registry as port_registry
from repro_torch.train import checkpoint as port_ckpt
from repro_torch.train import ft
from repro_torch.train import loop as port_loop
from repro_torch.train import losses as port_losses
from repro_torch.train import optimizer as port_opt
from test_torch_lm_grads import GRAD_RTOL, lm_batch, models_pair

# the cross entropies: chunked against full in one package, and the port's
# against the reference's: measured at most 1.4e-7 relative
CE_TOL = dict(rtol=1e-5, atol=0)
# their gradients with respect to the hidden states: measured at most
# 1.9e-9 absolute on entries up to 1.3e-2 (the reference's own test holds
# rtol 1e-4, atol 1e-6)
CE_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# the schedule, and the clip of a few dozen entries: measured equal
SCHED_TOL = dict(rtol=1e-7, atol=0)
# the clip of a 96,000-entry tree: torch and XLA sum the squares in other
# orders (ROADMAP.md queue 3, "Summation order"): measured 2.2e-7 relative
# on the norm and 3.3e-7 on the clipped entries
CLIP_TOL = dict(rtol=1e-6, atol=0)
# one optimizer apply: the largest difference measured is 8 % of this
# bound (adamw's parameters)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
# a resumed run against the uninterrupted one: the reference's own
# tolerance (tests/test_fault_tolerance.py); on the CPU the port's runs
# are bitwise equal, which the tests assert as well
RESUME_TOL = dict(rtol=1e-6, atol=1e-7)
# parameters and losses after whole steps against the reference's:
# measured at most 3.6e-7
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,seq,batch", [
    (0, 256, 16, 4), (3, 49152, 64, 8), (7, 51865, 32, 2)])
def test_token_batches_equal_the_reference(seed, vocab, seq, batch):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    want = ref_tokens.TokenPipeline(ref_tokens.TokenPipelineConfig(**kw))
    got = port_tokens.TokenPipeline(port_tokens.TokenPipelineConfig(**kw))
    for step in (0, 1, 5, 4096):
        a, b = got.batch(step), want.batch(step)
        assert a.keys() == b.keys() == {"tokens"}
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert got.state() == want.state() == {"seed": seed}
    # a pure function of (seed, step): a fresh pipeline repeats a batch
    again = port_tokens.TokenPipeline(port_tokens.TokenPipelineConfig(**kw))
    np.testing.assert_array_equal(again.batch(5)["tokens"],
                                  got.batch(5)["tokens"])
    assert not np.array_equal(got.batch(6)["tokens"], got.batch(5)["tokens"])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_id", [None, 3])
def test_shift_labels_equal_the_reference(pad_id):
    toks = rng(1).integers(0, 6, (3, 9)).astype(np.int32)
    want = ref_losses.shift_labels(jnp.asarray(toks), pad_id)
    got = port_losses.shift_labels(torch.from_numpy(toks), pad_id)
    assert got.dtype is torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert port_losses.IGNORE == ref_losses.IGNORE == -100
    assert port_losses.shift_labels(torch.tensor([[5, 6, 7]])).tolist() == \
        [[6, 7, -100]]


def _ce_inputs(B, L, seed, d=8, V=32, ignore_last=True):
    r = rng(seed)
    h = r.normal(size=(B, L, d)).astype(np.float32)
    labels = r.integers(0, V, (B, L)).astype(np.int32)
    if ignore_last:
        labels[:, -1] = port_losses.IGNORE
    w = (r.normal(size=(d, V)) * 0.1).astype(np.float32)
    return h, labels, w


def _port_fn(w):
    w = torch.from_numpy(w)
    return lambda x: x.float() @ w


def _ref_fn(w):
    w = jnp.asarray(w)
    return lambda x: x.astype(jnp.float32) @ w


# the reference test's shapes, then chunks that do not divide L
@pytest.mark.parametrize("B,L,chunk,seed", [
    (1, 3, 1, 0), (2, 12, 5, 7), (3, 17, 64, 123), (2, 16, 16, 10**6),
    (2, 17, 4, 5), (3, 13, 6, 9)])
def test_chunked_equals_full_and_the_reference(B, L, chunk, seed):
    h, labels, w = _ce_inputs(B, L, seed)
    got = port_losses.chunked_cross_entropy(
        torch.from_numpy(h), torch.from_numpy(labels), _port_fn(w), chunk)
    full = port_losses.full_cross_entropy(
        torch.from_numpy(h), torch.from_numpy(labels), _port_fn(w))
    want = ref_losses.chunked_cross_entropy(
        jnp.asarray(h), jnp.asarray(labels), _ref_fn(w), chunk=chunk)
    assert got.dtype is torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(full), **CE_TOL)
    np.testing.assert_allclose(float(got), float(want), **CE_TOL)


def test_all_ignored_is_zero():
    h = torch.ones((1, 4, 8))
    labels = torch.full((1, 4), port_losses.IGNORE)
    fn = _port_fn(_ce_inputs(1, 4, 0)[2])
    assert float(port_losses.chunked_cross_entropy(h, labels, fn, 2)) == 0.0
    assert float(port_losses.full_cross_entropy(h, labels, fn)) == 0.0


@pytest.mark.parametrize("chunk", [5, 12])
def test_gradients_match(chunk):
    h, labels, w = _ce_inputs(2, 12, 0, ignore_last=False)
    want = jax.grad(lambda x: ref_losses.chunked_cross_entropy(
        x, jnp.asarray(labels), _ref_fn(w), chunk=chunk))(jnp.asarray(h))
    grads = []
    for fn in (lambda x: port_losses.chunked_cross_entropy(
            x, torch.from_numpy(labels), _port_fn(w), chunk),
            lambda x: port_losses.full_cross_entropy(
                x, torch.from_numpy(labels), _port_fn(w))):
        x = torch.from_numpy(h).requires_grad_(True)
        grads.append(torch.autograd.grad(fn(x), x)[0].numpy())
    np.testing.assert_allclose(grads[0], grads[1], **CE_GRAD_TOL)
    np.testing.assert_allclose(grads[0], np.asarray(want), **CE_GRAD_TOL)


def test_gold_gather_equals_the_reference_masked_sum():
    """``_chunk_loss`` gathers the gold logit where the reference sums
    the logits under an iota mask: the same value bitwise, since every
    other term of the sum is zero."""
    r = rng(2)
    logits = torch.from_numpy(r.normal(size=(64, 300)).astype(np.float32))
    labels = torch.from_numpy(r.integers(0, 300, 64))
    iota = torch.arange(300)[None]
    masked = torch.where(iota == labels[:, None], logits, 0.0).sum(1)
    s, n = port_losses._chunk_loss(logits, labels, lambda x: x)
    want = (torch.logsumexp(logits, -1) - masked).sum()
    assert float(n) == 64
    assert torch.equal(torch.gather(logits, 1, labels[:, None])[:, 0],
                       masked)
    assert torch.equal(s, want)


def test_chunked_loss_keeps_no_logits_for_the_backward():
    """The memory property: under autograd the full loss saves its
    (B·L, V) logits for the backward, the chunked loss none of any
    chunk's (each chunk's are recomputed)."""
    B, L, d, V = 2, 40, 8, 512
    h, labels, w = _ce_inputs(B, L, 3, d=d, V=V)
    fn = _port_fn(w)

    def saved_numels(loss_fn):
        sizes = []

        def pack(t):
            sizes.append(t.numel())
            return t

        x = torch.from_numpy(h).requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = loss_fn(x)
        loss.backward()
        assert torch.isfinite(x.grad).all()
        return sizes

    full = saved_numels(lambda x: port_losses.full_cross_entropy(
        x, torch.from_numpy(labels), fn))
    chunked = saved_numels(lambda x: port_losses.chunked_cross_entropy(
        x, torch.from_numpy(labels), fn, 8))
    assert max(full) >= B * L * V
    assert max(chunked) < B * 8 * V


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(learning_rate=1.0, warmup_steps=10, decay_steps=100),
    dict(warmup_steps=0, decay_steps=7, min_lr_ratio=0.3)])
def test_lr_at_matches_the_reference(kw):
    rcfg, pcfg = ref_opt.OptConfig(**kw), port_opt.OptConfig(**kw)
    for step in (0, 1, 5, 10, 57, 100, 5000, 10100, 20000):
        want = ref_opt.lr_at(jnp.asarray(step, jnp.int32), rcfg)
        got = port_opt.lr_at(torch.tensor(step, dtype=torch.int32), pcfg)
        assert got.dtype is torch.float32
        np.testing.assert_allclose(float(got), float(want), **SCHED_TOL)


def test_lr_schedule_warmup_and_decay():
    cfg = port_opt.OptConfig(learning_rate=1.0, warmup_steps=10,
                             decay_steps=100, min_lr_ratio=0.1)
    lr = lambda s: float(port_opt.lr_at(torch.tensor(s), cfg))  # noqa: E731
    assert lr(5) == pytest.approx(0.5, rel=1e-5)
    assert lr(10) == pytest.approx(1.0, rel=1e-5)
    assert lr(110) == pytest.approx(0.1, rel=1e-3)


def _tree(seed, shapes):
    r = rng(seed)
    return {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"w": (160, 130), "b": (7,), "e": (3, 130, 140), "s": (4, 5)}


SMALL_SHAPES = {"w": (10,), "u": (6, 7), "b": (3,)}


@pytest.mark.parametrize("shapes,tol", [(SMALL_SHAPES, SCHED_TOL),
                                        (SHAPES, CLIP_TOL)],
                         ids=["small", "large"])
@pytest.mark.parametrize("max_norm", [0.0, 1.0, 1e6])
def test_clip_by_global_norm_matches_the_reference(max_norm, shapes, tol):
    g = _tree(0, shapes)
    want, wnorm = ref_opt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    got, norm = port_opt.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(norm), float(wnorm), **tol)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **tol)
    if max_norm == 1.0:
        total = float(torch.sqrt(sum((v ** 2).sum() for v in got.values())))
        assert total == pytest.approx(1.0, rel=1e-4)


def _state_np(state):
    if isinstance(state, dict):
        return {k: _state_np(v) for k, v in state.items()}
    return np.array(state)


def _state_torch(state):
    if isinstance(state, dict):
        return {k: _state_torch(v) for k, v in state.items()}
    return torch.from_numpy(np.array(state))


def _assert_trees_close(got, want, path="", **tol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], f"{path}/{k}", **tol)
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(want), path
    np.testing.assert_allclose(got, np.asarray(want), err_msg=path,
                               **(tol or OPT_TOL))


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_one_apply_at_a_time_matches_the_reference(name):
    """Three applies, each from the same parameters, gradients and state
    in both packages (the reference's last output fed to both): a
    trajectory would let a 1e-7 difference in a near-zero gradient grow
    into an lr-sized step.  Adafactor factors the (160, 130) and (3, 130,
    140) leaves (``factored_min_dim`` 128)."""
    kw = dict(name=name, learning_rate=1e-2, warmup_steps=2,
              decay_steps=10, weight_decay=0.1, grad_clip=5.0)
    rcfg, pcfg = ref_opt.OptConfig(**kw), port_opt.OptConfig(**kw)
    params = _tree(1, SHAPES)
    state = _state_np(ref_opt.init({k: jnp.asarray(v) for k, v in
                                    params.items()}, rcfg))
    port_state = port_opt.init({k: torch.from_numpy(v) for k, v in
                                params.items()}, pcfg)
    _assert_trees_close(port_state, state)
    if name == "adafactor":
        assert set(state["v"]["w"]) == {"vr", "vc"}
        assert state["v"]["e"]["vc"].shape == (3, 140)
        assert set(state["v"]["s"]) == {"v"}
    for i in range(3):
        grads = _tree(10 + i, SHAPES)
        grads["b"][:3] *= 1e-6            # near-zero entries
        want_p, want_s, want_m = ref_opt.apply(
            {k: jnp.asarray(v) for k, v in params.items()},
            {k: jnp.asarray(v) for k, v in grads.items()},
            jax.tree_util.tree_map(jnp.asarray, state), rcfg)
        got_p, got_s, got_m = port_opt.apply(
            {k: torch.from_numpy(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in grads.items()},
            _state_torch(state), pcfg)
        _assert_trees_close(got_p, _state_np(want_p))
        _assert_trees_close(got_s, _state_np(want_s))
        assert int(got_s["step"]) == i + 1
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(got_m[key]),
                                       float(want_m[key]), **OPT_TOL)
        params, state = _state_np(want_p), _state_np(want_s)


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_converges_on_quadratic(name):
    """The reference's own check: 300 steps on a quadratic."""
    cfg = port_opt.OptConfig(name=name, learning_rate=0.1, warmup_steps=0,
                             decay_steps=10**6, weight_decay=0.0,
                             grad_clip=0.0)
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    state = port_opt.init(params, cfg)
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - 3.0), "b": 2 * (params["b"] + 1.0)}
        params, state, _ = port_opt.apply(params, grads, state, cfg)
    loss = ((params["w"] - 3.0) ** 2).sum() + ((params["b"] + 1.0) ** 2).sum()
    assert float(loss) < 1e-2, name


def test_adamw_first_step_math():
    cfg = port_opt.OptConfig(name="adamw", learning_rate=1e-2,
                             warmup_steps=0, decay_steps=10**9,
                             min_lr_ratio=1.0, weight_decay=0.0,
                             grad_clip=0.0)
    p = {"w": torch.tensor([[1.0, 2.0]])}
    new, state, _ = port_opt.apply(p, {"w": torch.tensor([[0.5, -0.5]])},
                                   port_opt.init(p, cfg), cfg)
    expect = 1.0 - 1e-2 * 0.5 / (np.sqrt(0.25) + cfg.eps)
    assert float(new["w"][0, 0]) == pytest.approx(expect, rel=1e-5)
    assert state["m"]["w"].dtype is torch.float32


def test_optimizer_keeps_its_inputs_and_fp32_moments():
    cfg = port_opt.OptConfig(name="adamw")
    p = {"w": torch.ones((3, 3), dtype=torch.bfloat16)}
    g = {"w": torch.full((3, 3), 0.5, dtype=torch.bfloat16)}
    state = port_opt.init(p, cfg)
    before = {k: v.clone() for k, v in state["m"].items()}
    new, new_state, _ = port_opt.apply(p, g, state, cfg)
    assert new["w"].dtype is torch.bfloat16
    assert new_state["v"]["w"].dtype is torch.float32
    assert (p["w"] == 1).all() and torch.equal(state["m"]["w"],
                                               before["w"])
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    with pytest.raises(ValueError, match="unknown optimizer"):
        port_opt.init(p, port_opt.OptConfig(name="lion"))


# ---------------------------------------------------------------------------
# the optimizer half of the checkpoint
# ---------------------------------------------------------------------------

def _opt_state(name="adafactor"):
    cfg = port_opt.OptConfig(name=name, factored_min_dim=4)
    params = {k: torch.from_numpy(v) for k, v in
              _tree(4, {"layers.0.w": (8, 6), "b": (5,)}).items()}
    grads = {k: torch.from_numpy(v) for k, v in
             _tree(5, {"layers.0.w": (8, 6), "b": (5,)}).items()}
    new, state, _ = port_opt.apply(params, grads,
                                   port_opt.init(params, cfg), cfg)
    return new, state


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
        return
    assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_checkpoint_round_trips_optimizer_state(tmp_path, name):
    params, state = _opt_state(name)
    d = str(tmp_path / "ck")
    port_ckpt.save(d, 3, params, state, extra={"pipeline": {"seed": 1}})
    step, p, opt, extra = port_ckpt.restore(d, params_template=params,
                                            opt_template=state)
    assert step == 3 and extra == {"pipeline": {"seed": 1}}
    _assert_trees_equal(p, params)
    _assert_trees_equal(opt, state)
    assert opt["step"].dtype is torch.int32 and opt["step"].shape == ()
    # the three-value form, and the stored keys
    step, p, extra = port_ckpt.restore(d, params_template=params)
    _assert_trees_equal(p, params)
    with np.load(os.path.join(d, "step_0000000003", "arrays.npz")) as z:
        assert "opt::step" in z.files and "params::layers.0.w" in z.files
    # through the asynchronous saver
    saver = port_ckpt.AsyncSaver()
    saver.save_async(d, 4, params, state, extra={"pipeline": {"seed": 1}})
    saver.wait()
    _, _, opt, _ = port_ckpt.restore(d, params_template=params,
                                     opt_template=state)
    _assert_trees_equal(opt, state)


def test_optimizer_state_crosses_the_packages(tmp_path):
    """A port checkpoint with optimizer state restores in the reference,
    and the reference's in the port."""
    params, state = _opt_state("adafactor")
    np_params, np_state = _state_np(params), _state_np(state)
    port_ckpt.save(str(tmp_path / "a"), 2, params, state)
    step, p, opt, _ = ref_ckpt.restore(str(tmp_path / "a"),
                                       params_template=np_params,
                                       opt_template=np_state)
    assert step == 2
    _assert_trees_equal(p, np_params)
    _assert_trees_equal(opt, np_state)
    ref_ckpt.save(str(tmp_path / "b"), 5, np_params, np_state)
    step, p, opt, _ = port_ckpt.restore(str(tmp_path / "b"),
                                        params_template=params,
                                        opt_template=state)
    assert step == 5
    _assert_trees_equal(p, params)
    _assert_trees_equal(opt, state)


@pytest.mark.filterwarnings("ignore:batch_size=32 does not divide")
def test_a_kg_checkpoint_has_no_optimizer_state(tmp_path):
    """A ``KnowledgeBase`` artifact (no ``opt::`` arrays, ``has_opt``
    false) restores with an ``opt_template`` to ``opt=None``, and as
    before without one."""
    graph = port_kg_lib.synthetic_kg(0, n_entities=60, n_relations=4,
                                     n_triplets=400)
    res = port_kg.fit(graph, epochs=1, dim=8, batch_size=32, n_workers=1,
                      device="cpu")
    d = str(tmp_path / "kb")
    res.kb.save(d)
    step, tree, opt, extra = port_ckpt.restore(
        d, opt_template={"step": torch.zeros((), dtype=torch.int32)})
    assert opt is None and extra["kind"] == "knowledge_base"
    _, tree3, extra3 = port_ckpt.restore(d)
    assert extra3 == extra
    np.testing.assert_array_equal(tree["params"]["ent"],
                                  tree3["params"]["ent"])


# ---------------------------------------------------------------------------
# whole steps of ``make_train_step`` against the reference's
# ---------------------------------------------------------------------------

def _sgd():
    kw = dict(name="sgd", learning_rate=0.1, warmup_steps=1,
              decay_steps=10, grad_clip=1.0)
    return ref_opt.OptConfig(**kw), port_opt.OptConfig(**kw)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-moe-a2.7b",
                                  "mamba2-130m"])
def test_three_sgd_steps_match_the_reference(arch):
    """A trajectory held under ``sgd``, where a small difference in a
    gradient moves a parameter by a small step (under AdamW or Adafactor
    a 1e-7 difference in a near-zero gradient becomes an lr-sized
    step)."""
    ref_task, params, port_task, model = models_pair(arch)
    rcfg, pcfg = _sgd()
    ref_step = jax.jit(ref_loop.make_train_step(ref_task, rcfg))
    port_step = port_loop.make_train_step(port_task, pcfg)
    ref_state = ref_opt.init(params, rcfg)
    port_state = port_opt.init(port_loop.named_params(model), pcfg)
    for i in range(3):
        batch = lm_batch(port_task.cfg, 10 + i)
        params, ref_state, rm = ref_step(
            params, ref_state, jax.tree_util.tree_map(jnp.asarray, batch))
        model, port_state, pm = port_step(model, port_state, batch)
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   **STEP_TOL)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), **STEP_TOL)
    assert int(port_state["step"]) == 3
    want = convert.lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), port_task.cfg,
        device="cpu")
    for (name, got), (_, w) in zip(model.named_parameters(),
                                   want.named_parameters()):
        np.testing.assert_allclose(got.detach().numpy(), w.numpy(),
                                   err_msg=name, **STEP_TOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-base"])
def test_microbatches_match_the_reference_and_one_batch(arch):
    """``microbatches=2`` (whisper-base's ``train_microbatches``): the
    batch's leading dim split in two runs, the two gradients summed in
    fp32 and halved (bitwise those of the two halves), the step against
    the reference's on the same batch, and against one microbatch, which
    each half's equal count of labels makes the same mean."""
    ref_task, params, port_task, model = models_pair(arch)
    cfg = port_task.cfg
    batch = lm_batch(cfg, 3, batch=4, length=16)
    if cfg.encoder_decoder:
        batch["frames"] = np.random.default_rng(4).normal(
            size=(4, 16, cfg.d_model)).astype(np.float32)
    halves = [port_loop.value_and_grad(
        port_task, model, {k: v[i:i + 2] for k, v in batch.items()})
        for i in (0, 2)]
    loss, grads = port_loop.loss_and_grads(port_task, model, batch, 2)
    assert float(loss) == float((halves[0][0] + halves[1][0]) / 2)
    whole = port_loop.loss_and_grads(port_task, model, batch)
    np.testing.assert_allclose(float(loss), float(whole[0]), **STEP_TOL)
    for name, g in grads.items():
        assert g.dtype is torch.float32
        assert torch.equal(g, (halves[0][1][name] + halves[1][1][name]) / 2)
        np.testing.assert_allclose(
            g.numpy(), whole[1][name].numpy(), rtol=0,
            atol=GRAD_RTOL * max(float(whole[1][name].abs().max()), 1e-30),
            err_msg=name)
    # the whole step against the reference's
    kw = dict(name="sgd", learning_rate=0.1, warmup_steps=0,
              decay_steps=10, grad_clip=0.0, momentum=0.0)
    rcfg, pcfg = ref_opt.OptConfig(**kw), port_opt.OptConfig(**kw)
    want, _, rm = jax.jit(ref_loop.make_train_step(ref_task, rcfg, 2))(
        params, ref_opt.init(params, rcfg),
        jax.tree_util.tree_map(jnp.asarray, batch))
    step = port_loop.make_train_step(port_task, pcfg, microbatches=2)
    got, _, pm = step(model, port_opt.init(port_loop.named_params(model),
                                           pcfg), batch)
    assert float(pm["loss"]) == float(loss)
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               **STEP_TOL)
    want = convert.lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, want), cfg, device="cpu")
    for (name, p), (_, w) in zip(got.named_parameters(),
                                 want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(),
                                   err_msg=name, **STEP_TOL)


# ---------------------------------------------------------------------------
# the Trainer and fault tolerance (tests/test_fault_tolerance.py mirrored)
# ---------------------------------------------------------------------------

def make_trainer(ckpt_dir, steps, opt="adamw"):
    cfg = port_configs.get_config("smollm-135m", reduced=True)
    task = port_registry.make_task(cfg, "cpu")
    pipe = port_tokens.TokenPipeline(port_tokens.TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=3))
    opt_cfg = port_opt.OptConfig(name=opt, learning_rate=1e-3,
                                 warmup_steps=2, decay_steps=100)
    tcfg = port_loop.TrainConfig(steps=steps, log_every=0, ckpt_every=4,
                                 ckpt_dir=ckpt_dir)
    return port_loop.Trainer(task, pipe, opt_cfg, tcfg)


def _assert_same_run(a, b):
    for (ka, pa), (kb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert ka == kb
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(),
                                   **RESUME_TOL)
        assert torch.equal(pa, pb), ka


_UNINTERRUPTED = {}


def uninterrupted(tmp_path_factory, opt="adamw"):
    if opt not in _UNINTERRUPTED:
        t = make_trainer(str(tmp_path_factory.mktemp("ref") / "ck"), 8, opt)
        params, state = t.run(seed=0, resume=False)
        _UNINTERRUPTED[opt] = (t, params, state)
    return _UNINTERRUPTED[opt]


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_resume_reproduces_uninterrupted_run(tmp_path, tmp_path_factory,
                                             opt):
    t_ref, params_ref, state_ref = uninterrupted(tmp_path_factory, opt)
    make_trainer(str(tmp_path / "int"), 4, opt).run(seed=0, resume=False)
    assert port_ckpt.latest_step(str(tmp_path / "int")) == 4
    t_b = make_trainer(str(tmp_path / "int"), 8, opt)
    params_b, state_b = t_b.run(seed=0, resume=True)
    assert len(t_b.history) == 4
    assert t_b.history == t_ref.history[4:]
    _assert_same_run(params_ref, params_b)
    _assert_trees_equal(_state_np(state_b), _state_np(state_ref))
    # the final save holds the optimizer state and the pipeline's seed
    _, _, opt_state, extra = port_ckpt.restore(
        str(tmp_path / "int"), params_template=port_loop.named_params(
            params_b), opt_template=state_b)
    assert extra == {"pipeline": {"seed": 3}}
    _assert_trees_equal(_state_np(opt_state), _state_np(state_b))


def test_run_with_recovery_restarts_on_injected_failure(tmp_path,
                                                        tmp_path_factory):
    ckpt = str(tmp_path / "ckpt")
    injector = ft.FailureInjector(fail_at=(5,))
    calls = {"restarts": 0}

    def make_loop():
        trainer = make_trainer(ckpt, steps=8)

        def run():
            orig_batch = trainer.pipeline.batch

            def batch(step):
                injector.maybe_fail(step)
                return orig_batch(step)

            trainer.pipeline.batch = batch
            return trainer.run(seed=0, resume=True)

        return run

    def on_restart(attempt, err):
        calls["restarts"] += 1
        assert "injected failure" in str(err)

    params, _ = ft.run_with_recovery(make_loop, max_restarts=2,
                                     on_restart=on_restart)
    assert calls["restarts"] == 1
    _assert_same_run(uninterrupted(tmp_path_factory)[1], params)


def test_run_with_recovery_gives_up_after_max_restarts():
    attempts = []

    def make_loop():
        def run():
            attempts.append(1)
            raise RuntimeError("node lost")
        return run

    with pytest.raises(RuntimeError, match="node lost"):
        ft.run_with_recovery(make_loop, max_restarts=2)
    assert len(attempts) == 3
    inj = ft.FailureInjector(fail_at=(1,))
    inj.maybe_fail(0)
    with pytest.raises(RuntimeError, match="injected failure at step 1"):
        inj.maybe_fail(1)
    inj.maybe_fail(1)                      # only the first time


def test_heartbeat(tmp_path):
    path = str(tmp_path / "hb")
    ft.heartbeat(path, 12)
    step, stamp = open(path).read().split()
    assert step == "12" and float(stamp) > 0


def test_loss_decreases_on_markov_stream(capsys):
    cfg = port_configs.get_config("smollm-135m", reduced=True)
    task = port_registry.make_task(cfg, "cpu")
    pipe = port_tokens.TokenPipeline(port_tokens.TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0))
    opt_cfg = port_opt.OptConfig(name="adamw", learning_rate=3e-3,
                                 warmup_steps=5, decay_steps=1000)
    tcfg = port_loop.TrainConfig(steps=30, log_every=10, ckpt_dir=None)
    tr = port_loop.Trainer(task, pipe, opt_cfg, tcfg)
    tr.run(seed=0, resume=False)
    first = np.mean(tr.history[:5])
    last = np.mean(tr.history[-5:])
    assert last < first, (first, last)
    logged = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in logged] == [
        "step 10", "step 20", "step 30"]
    assert logged[-1].startswith(f"step 30: loss={tr.history[-1]:.4f} (")


def test_reference_and_port_configs_agree_for_training():
    """The fields the trainer reads keep the reference's values."""
    for arch in ref_configs.ARCH_IDS:
        want = ref_configs.get_config(arch)
        got = port_configs.get_config(arch)
        assert (got.remat, got.ce_chunk, got.train_microbatches,
                got.optimizer) == (want.remat, want.ce_chunk,
                                   want.train_microbatches, want.optimizer)
