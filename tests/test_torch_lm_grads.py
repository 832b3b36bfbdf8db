"""The port's LM training step against the reference's, at ``reduced()``
width in fp32 on the CPU, both packages starting from the reference's
parameters (carried across by ``convert.lm_params_from_reference``, which
also carries the reference's gradient pytree into the port's names):
``DecoderTask.loss`` and its gradients for every decoder-only arch
against ``jax.value_and_grad(task.loss)`` (the encoder-decoder's are in
``tests/test_torch_lm_encdec.py``; whole steps, ``make_train_step``, in
``tests/test_torch_lm_train.py``, on this file's helpers).  The MoE archs
run at the reduced configs' dropless capacity factor (4.0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import registry as ref_registry
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.models import registry as port_registry
from repro_torch.train import loop as port_loop

DECODER_ARCHS = [a for a in ref_configs.ARCH_IDS if a != "whisper-base"]
# the loss: measured at most 1.4e-6 (qwen2-moe-a2.7b, a loss of 5.9)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
# every gradient, relative to its largest entry: measured at most 8.3e-6
# (recurrentgemma-9b's RG-LRU gates, whose scan the port differentiates
# through ``common.linear_scan`` and the reference through
# ``associative_scan``), 2.3e-6 (mamba2-130m's A_log), 2.0e-6 elsewhere
GRAD_RTOL = 1e-4
B, L = 2, 24


def models_pair(arch):
    """(reference task, its params, port task, the port model holding
    those params) at ``arch``'s reduced width."""
    ref_cfg = ref_configs.get_config(arch, reduced=True)
    port_cfg = port_configs.get_config(arch, reduced=True)
    ref_task = ref_registry.make_task(ref_cfg)
    params = jax.jit(ref_task.init)(jax.random.PRNGKey(0))
    port_task = port_registry.make_task(port_cfg, "cpu")
    model = convert.lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), port_cfg, device="cpu")
    return ref_task, params, port_task, model


def lm_batch(cfg, seed, batch=B, length=L):
    r = np.random.default_rng(seed)
    out = {"tokens": r.integers(0, cfg.vocab_size,
                                (batch, length)).astype(np.int32)}
    if cfg.vision_tokens:
        out["patch_embeds"] = (r.normal(size=(
            batch, cfg.vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def assert_grads_close(port_grads, ref_grads, cfg):
    ref = convert.lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_grads), cfg, device="cpu")
    assert sorted(k for k, _ in ref.named_parameters()) == sorted(port_grads)
    for name, g in ref.named_parameters():
        w = g.detach().numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(port_grads[name].numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)
    return ref


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    ref_task, params, port_task, model = models_pair(arch)
    batch = lm_batch(port_task.cfg, 1)
    want, grads = jax.jit(jax.value_and_grad(ref_task.loss))(
        params, jax.tree_util.tree_map(jnp.asarray, batch))
    got, port_grads = port_loop.value_and_grad(port_task, model, batch)
    assert got.dtype is torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    ref = assert_grads_close(port_grads, grads, port_task.cfg)
    # every parameter is reached, padded MoE expert rows aside (zero in
    # both packages)
    for name, g in ref.named_parameters():
        if not name.endswith(("ffn.wi", "ffn.wg", "ffn.wo")):
            assert float(g.abs().max()) > 0, name
