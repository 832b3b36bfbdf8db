"""The port's LM configs (``repro_torch.configs``) against the reference's:
every field, ``segments`` and the derived widths of all ten archs, full
and ``reduced()``, with the JAX dtypes mapped to torch's."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import configs as ref_configs
from repro_torch import configs as port_configs
from repro_torch.models import common

DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}


def test_registry_matches():
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert len(port_configs.ARCH_IDS) == 10
    assert {f.name for f in dataclasses.fields(common.ModelConfig)} == {
        f.name for f in dataclasses.fields(type(
            ref_configs.get_config("smollm-135m")))}


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_config_matches_the_reference(arch, reduced):
    want = ref_configs.get_config(arch, reduced=reduced)
    got = port_configs.get_config(arch, reduced=reduced)
    assert isinstance(got, common.ModelConfig)
    for field in dataclasses.fields(want):
        w, g = getattr(want, field.name), getattr(got, field.name)
        if field.name in ("dtype", "param_dtype"):
            assert g is DTYPES[jnp.dtype(w)], field.name
        else:
            assert g == w and type(g) is type(w), field.name
    assert got.segments == want.segments
    assert (got.head_dim_, got.d_rnn) == (want.head_dim_, want.d_rnn)
    # the port's per-layer order is the reference's segments unrolled
    assert len(got.layer_kinds) == got.n_layers
    assert got.layer_kinds == tuple(
        kind for pattern, reps in want.segments for _ in range(reps)
        for kind in pattern)


def test_reduced_takes_overrides():
    got = port_configs.get_config("gemma2-2b", reduced=True).reduced(
        dtype=torch.bfloat16, window=8)
    assert got.dtype is torch.bfloat16 and got.window == 8
    assert port_configs.get_config("qwen3-4b").dtype is torch.bfloat16


@pytest.mark.parametrize("arch,n_params", [
    ("qwen2-moe-a2.7b", 15_146_059_776),
    ("deepseek-v2-236b", 235_741_434_880)])
def test_moe_archs_hold_the_reference_parameters_at_full_width(arch,
                                                                n_params):
    """The port's full-width model, built on the meta device (no memory),
    holds the reference's parameter shapes, padded expert rows included
    (qwen2-moe's 60 experts in 64 rows): one tensor a layer for each of
    the reference's stacked ones."""
    _holds_the_reference_parameters(arch, n_params)


@pytest.mark.parametrize("arch,n_params", [
    ("mamba2-130m", 128_983_488),
    ("recurrentgemma-9b", 8_578_519_040)])
def test_recurrent_archs_hold_the_reference_parameters_at_full_width(
        arch, n_params):
    """As above for the SSM and RG-LRU archs: mamba2's 24 SSD layers (no
    FFN) and recurrentgemma's 38 layers in two segments, the trailing
    (rec, rec) included, with the block-diagonal (16, 256, 256) gates."""
    model = _holds_the_reference_parameters(arch, n_params)
    if arch == "recurrentgemma-9b":
        assert [b.kind for b in model.layers[-3:]] == ["local", "rec", "rec"]
        assert tuple(model.layers[-1].mixer["w_a"].shape) == (16, 256, 256)
    else:
        assert not any(hasattr(b, "ffn") for b in model.layers)


def test_encdec_holds_the_reference_parameters_at_full_width():
    """whisper-base: 6 encoder and 6 decoder layers (each decoder layer
    with its cross attention), LayerNorm scales and biases, the tied
    51,865-row embedding."""
    model = _holds_the_reference_parameters("whisper-base", 70_627_840)
    assert (len(model.enc), len(model.dec)) == (6, 6)
    assert tuple(model.dec[0].cross_attn["wq"].shape) == (512, 8, 64)
    assert tuple(model.enc[0].mlp["wi"].shape) == (512, 2048)
    assert "wg" not in model.enc[0].mlp


def _holds_the_reference_parameters(arch, n_params):
    import collections

    import jax

    from repro.models import registry as ref_registry
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.transformer import DecoderLM

    cfg = port_configs.get_config(arch)
    model = (EncDecLM if cfg.encoder_decoder else DecoderLM)(cfg, "meta")
    got = collections.Counter(tuple(p.shape) for p in model.parameters())
    ref_cfg = ref_configs.get_config(arch)
    shapes = jax.eval_shape(ref_registry.make_task(ref_cfg).init,
                            jax.random.PRNGKey(0))
    want = collections.Counter()
    for name, tree in shapes.items():
        for leaf in jax.tree_util.tree_leaves(tree):
            # stacked over the repeats, or over an encoder-decoder's layers
            if name.startswith("seg") or name in ("enc", "dec"):
                want[tuple(leaf.shape[1:])] += leaf.shape[0]
            else:
                want[tuple(leaf.shape)] += 1
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == n_params
    return model
