"""The LM mesh over four gloo ranks (a 2 x 2 ``("data", "model")`` mesh,
``tests/torch_lm_rank_worker.py``, one process group for the file,
started in a module fixture through a ``FileStore`` under ``tmp_path``):

  * ``constrain`` redistributing DTensor activations to the reference's
    specs, keeping the mesh's axes that divide;
  * the expert-parallel MoE dispatch (``moe._apply_moe_shardmap``) at the
    reference helper's config (8 experts, top-2, ``fsdp_tp``): at
    cf 4.0 within 1e-5 of the port's scatter path on the whole batch,
    outputs, aux loss and gradients (1e-4); at cf 1.0, where pairs drop,
    within 1e-5 of the reference's ``_apply_moe_shardmap`` on a (2, 2)
    mesh of forced host devices (a subprocess, as
    ``tests/test_multidevice.py`` runs the reference's helper);
  * ``Trainer(mesh=...)`` on reduced smollm-135m and qwen2-moe-a2.7b under
    ``fsdp_tp`` in fp32: 3 steps' losses and parameters within 1e-5 of
    the mesh-less ``Trainer``.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax

from repro import configs as ref_configs
from repro.models import moe as ref_moe

import torch_lm_rank_worker as worker

WORLD = 4
JOIN_S = 300
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
CFS = (4.0, 1.0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _ref_cfg(cf):
    import jax.numpy as jnp

    return ref_configs.get_config("qwen2-moe-a2.7b", reduced=True).reduced(
        n_experts=8, top_k=2, moe_d_ff=16, d_model=32, capacity_factor=cf,
        sharding_profile="fsdp_tp", dtype=jnp.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _moe_inputs(cf):
    """The reference helper's parameters and batch."""
    cfg = _ref_cfg(cf)
    p = ref_moe.init_moe(jax.random.PRNGKey(0), cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model))
    return {"params": _flat(p), "x": np.asarray(x, np.float32)}


REF_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[3])
    import jax, jax.numpy as jnp, numpy as np
    from repro import configs
    from repro.models import moe
    inputs = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    for cf, inp in inputs.items():
        cfg = configs.get_config("qwen2-moe-a2.7b", reduced=True).reduced(
            n_experts=8, top_k=2, moe_d_ff=16, d_model=32,
            capacity_factor=cf, sharding_profile="fsdp_tp",
            dtype=jnp.float32)
        flat = inp["params"]
        p = {k: jnp.asarray(v) for k, v in flat.items() if "." not in k}
        shared = {k.split(".", 1)[1]: jnp.asarray(v)
                  for k, v in flat.items() if k.startswith("shared.")}
        if shared:
            p["shared"] = shared
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
        with mesh:
            o, a = jax.jit(lambda p, x: moe._apply_moe_shardmap(
                p, x, cfg, mesh, ("data",)))(p, jnp.asarray(inp["x"]))
        out[cf] = (np.asarray(o), float(a))
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the four ranks and the reference subprocess together; join
    each within JOIN_S, kill the rest in ``finally``."""
    d = tmp_path_factory.mktemp("lm_mesh")
    inputs = {cf: _moe_inputs(cf) for cf in CFS}
    with open(d / "inputs", "wb") as f:
        pickle.dump(inputs, f)
    spec = {"suite": "mesh", "world": WORLD, "store": str(d / "store"),
            "inputs": str(d / "inputs"), "out": str(d / "res")}
    with open(d / "spec", "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    ref_env = dict(env)
    ref_env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(d / "spec"), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(d / "inputs"),
         str(d / "ref"), SRC], env=ref_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=JOIN_S)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    res = []
    for r in range(WORLD):
        with open(f"{spec['out']}.{r}", "rb") as f:
            res.append(pickle.load(f))
    with open(d / "ref", "rb") as f:
        ref = pickle.load(f)
    return {"ranks": res, "ref": ref, "inputs": inputs}


@pytest.mark.parametrize("rank", range(WORLD))
def test_constrain_redistributes_a_dtensor(ranks, rank):
    """Only the mesh's axes, and of a group the prefix that divides the
    dim: ("pod", "data") keeps "data"; 3 rows take no data-parallel
    axis; ``constrain_batch`` under ``dp`` cuts dim 0 over both axes.
    The values stay whole."""
    got = ranks["ranks"][rank]["constrain"]
    assert got["batch"] == (["S(0)", "S(2)"], True)
    assert got["odd"] == (["R", "R"], True)
    assert got["batch_dp"] == (["S(0)", "S(0)"], True)


@pytest.mark.parametrize("rank", range(WORLD))
def test_dispatch_is_expert_parallel(ranks, rank):
    for cf in CFS:
        r = ranks["ranks"][rank]["moe"][cf]
        assert r["calls"] == 1
        assert r["e_loc"] == 8       # 16 padded experts over model = 2


@pytest.mark.parametrize("rank", range(WORLD))
def test_dispatch_matches_scatter(ranks, rank):
    r = ranks["ranks"][rank]["moe"][4.0]
    np.testing.assert_allclose(r["out"], r["scatter_out"], **TOL)
    np.testing.assert_allclose(r["aux"], r["scatter_aux"], **TOL)


@pytest.mark.parametrize("rank", range(WORLD))
def test_dispatch_gradients_match_scatter(ranks, rank):
    r = ranks["ranks"][rank]["moe"][4.0]
    np.testing.assert_allclose(r["x_grad"], r["scatter_x_grad"],
                               rtol=1e-4, atol=1e-4)
    assert set(r["grads"]) == set(r["scatter_grads"])
    for k, g in r["grads"].items():
        np.testing.assert_allclose(g, r["scatter_grads"][k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("cf", CFS)
def test_dispatch_matches_reference_shard_map(ranks, cf):
    """The ranks' rows assembled against the reference's dispatch on a
    (2, 2) mesh; at cf 1.0 pairs drop, and the same ones."""
    ref_out, ref_aux = ranks["ref"][cf]
    B = ranks["inputs"][cf]["x"].shape[0]
    out = np.zeros_like(ranks["inputs"][cf]["x"])
    assert [r["moe"][cf]["rows"] for r in ranks["ranks"][::2]] == \
        [(0, B // 2), (B // 2, B)]       # ranks 0 and 2: data 0 and 1
    for r in ranks["ranks"]:
        lo, hi = r["moe"][cf]["rows"]
        out[lo:hi] = r["moe"][cf]["out"]
        np.testing.assert_allclose(r["moe"][cf]["aux"], ref_aux, **TOL)
    assert out.shape[0] == B
    np.testing.assert_allclose(out, ref_out.reshape(out.shape), **TOL)
    if cf == 1.0:
        # pairs drop at cf 1.0: the output is not the dropless one
        dropless = np.concatenate([r["moe"][4.0]["out"]
                                   for r in ranks["ranks"][::2]])
        assert np.abs(out - dropless).max() > 1e-3


def _unflat(flat):
    p = {k: v for k, v in flat.items() if "." not in k}
    shared = {k.split(".", 1)[1]: v for k, v in flat.items()
              if k.startswith("shared.")}
    if shared:
        p["shared"] = shared
    return p


@pytest.mark.parametrize("arch", worker.TRAIN_ARCHS)
def test_mesh_trainer_matches_meshless(ranks, arch):
    plain = ranks["ranks"][0]["train_plain"][arch]
    assert len(plain["history"]) == worker.TRAIN_STEPS
    for r in ranks["ranks"]:
        got = r["train"][arch]
        np.testing.assert_allclose(got["history"], plain["history"], **TOL)
        assert set(got["params"]) == set(plain["params"])
        for k, v in got["params"].items():
            np.testing.assert_allclose(v, plain["params"][k], err_msg=k,
                                       **TOL)
