"""The cross-pod outer merge (``core/local_sgd.py``) over gloo ranks
against the reference's ``outer_merge`` under ``jax.vmap(...,
axis_name="pod")`` (which binds ``psum`` / ``pmax`` / ``axis_index`` on
one CPU device), on the same numpy parameters.

Every strategy, ``compress`` none and int8, outer momentum 0 and 0.9
(from a nonzero momentum), with and without a liveness mask holding a
dead pod, over 2 and 4 ranks (``tests/torch_lm_rank_worker.py``, each
group started once for the file through a ``FileStore``).  The int8 mean
and the winner strategies are bitwise; the fp32 mean and its momentum
within 1e-6.  The ``random`` strategy's per-pod priority is the
reference's ``uniform(fold_in(key, pod))``, handed to each rank as its
draw.
"""
import itertools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import local_sgd as ref
from repro_torch.core import local_sgd

import torch_lm_rank_worker as worker

MESHES = (2, 4)
JOIN_S = 240
SHAPES = {"w": (16, 12), "b": (12,), "e": (3, 5, 7)}
LIVE = {2: [1.0, 0.0], 4: [1.0, 0.0, 1.0, 1.0]}


def _grid():
    """{case name: (strategy, compress, outer momentum, a dead pod)}."""
    grid = itertools.product(("average", "random", "miniloss_global"),
                             ("none", "int8"), (0.0, 0.9), (False, True))
    return {f"{st}-{c}-mu{mu}-{'live' if lv else 'all'}": (st, c, mu, lv)
            for st, c, mu, lv in grid if st == "average" or not mu}


def _cases(M):
    rng = np.random.default_rng(M)
    out = {}
    anchor = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    params = {k: (a[None] + 0.1 * rng.normal(size=(M,) + a.shape))
              .astype(np.float32) for k, a in anchor.items()}
    mom0 = {k: (0.05 * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}
    loss = rng.uniform(1.0, 2.0, size=M).astype(np.float32)
    key = jax.random.PRNGKey(7)
    draw = np.asarray([jax.random.uniform(jax.random.fold_in(key, i), ())
                       for i in range(M)], np.float32)
    for name, (strategy, compress, mu, live) in _grid().items():
        out[name] = {
            "cfg": dict(strategy=strategy, compress=compress,
                        outer_momentum=mu, outer_lr=0.7),
            "params": params, "anchor": anchor,
            "momentum": mom0 if mu else None,
            "liveness": np.asarray(LIVE[M], np.float32) if live else None,
            "loss": loss, "draw": draw, "key": key}
    return out


def _reference(case):
    """The reference's merge of every pod at once: (merged (M, ...),
    momentum or None)."""
    cfg = ref.OuterConfig(**case["cfg"])
    anchor = {k: jnp.asarray(v) for k, v in case["anchor"].items()}
    state = ref.OuterState.init(anchor, cfg)
    if case["momentum"] is not None:
        state = ref.OuterState(anchor, {k: jnp.asarray(v) for k, v in
                                        case["momentum"].items()})
    M = len(case["loss"])
    live = case["liveness"]
    live = jnp.ones((M,), jnp.float32) if live is None else jnp.asarray(live)

    def one(params, loss, lv):
        merged, new = ref.outer_merge(
            params, state, cfg, local_loss=loss, key=case["key"],
            liveness=lv if case["liveness"] is not None else None)
        return merged, new.momentum

    merged, mom = jax.vmap(one, axis_name="pod")(
        {k: jnp.asarray(v) for k, v in case["params"].items()},
        jnp.asarray(case["loss"]), live)
    return ({k: np.asarray(v) for k, v in merged.items()},
            None if mom is None else {k: np.asarray(v)
                                      for k, v in mom.items()})


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    """Both rank groups started together, each rank joined within
    JOIN_S, the rest killed in ``finally``: {M: [rank results]}."""
    d = tmp_path_factory.mktemp("outer")
    procs, specs = [], {}
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for M in MESHES:
        cases = _cases(M)
        with open(d / f"cases{M}", "wb") as f:
            pickle.dump({n: {k: v for k, v in c.items() if k != "key"}
                         for n, c in cases.items()}, f)
        spec = {"suite": "outer", "world": M, "store": str(d / f"store{M}"),
                "inputs": str(d / f"cases{M}"), "out": str(d / f"res{M}")}
        specs[M] = spec
        with open(d / f"spec{M}", "wb") as f:
            pickle.dump(spec, f)
        procs += [subprocess.Popen(
            [sys.executable, worker.__file__, str(d / f"spec{M}"), str(r)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(M)]
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
    out = {}
    for M, spec in specs.items():
        out[M] = []
        for r in range(M):
            with open(f"{spec['out']}.{r}", "rb") as f:
                out[M].append(pickle.load(f))
    return out


CASE_NAMES = sorted(_grid())


@pytest.mark.parametrize("M", MESHES)
@pytest.mark.parametrize("name", CASE_NAMES)
def test_outer_merge_matches_reference(merged, M, name):
    case = _cases(M)[name]
    want, want_mom = _reference(case)
    exact = (case["cfg"]["compress"] == "int8"
             or case["cfg"]["strategy"] != "average")
    for r in range(M):
        got = merged[M][r][name]
        for k, v in want.items():
            if exact:
                np.testing.assert_array_equal(got["merged"][k], v[r],
                                              err_msg=k)
            else:
                np.testing.assert_allclose(got["merged"][k], v[r],
                                           rtol=1e-6, atol=1e-6, err_msg=k)
        if want_mom is None:
            assert got["momentum"] is None
        else:
            for k, v in want_mom.items():
                np.testing.assert_allclose(got["momentum"][k], v[r],
                                           rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("M", MESHES)
def test_winner_is_a_live_pod(merged, M):
    """random and miniloss_global hand every rank one live pod's
    parameters; a dead pod never wins."""
    case = _cases(M)["miniloss_global-none-mu0.0-live"]
    live = case["liveness"]
    loss = np.where(live > 0, case["loss"], np.inf)
    win = int(np.argmin(loss))
    for r in range(M):
        got = merged[M][r]["miniloss_global-none-mu0.0-live"]["merged"]
        for k in SHAPES:
            np.testing.assert_array_equal(got[k], case["params"][k][win])


def test_quantize_int8_matches_reference():
    x = np.random.default_rng(0).normal(size=(33, 7)).astype(np.float32)
    q, s = local_sgd.quantize_int8(torch.from_numpy(x))
    rq, rs = ref.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        local_sgd.dequantize_int8(q, s, torch.float32).numpy(),
        np.asarray(ref.dequantize_int8(rq, rs, jnp.float32)))


def test_should_sync_and_config():
    cfg = local_sgd.OuterConfig(sync_period=4)
    assert [bool(local_sgd.should_sync(s, cfg)) for s in range(1, 9)] == \
        [bool(ref.should_sync(s, ref.OuterConfig(sync_period=4)))
         for s in range(1, 9)]
    assert local_sgd.OuterConfig() == local_sgd.OuterConfig(
        **{f: getattr(ref.OuterConfig(), f)
           for f in ref.OuterConfig.__dataclass_fields__})


def test_random_needs_a_draw(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
        p = {"w": torch.ones(3)}
        cfg = local_sgd.OuterConfig(strategy="random")
        with pytest.raises(ValueError, match="draw"):
            local_sgd.outer_merge(p, local_sgd.OuterState.init(p, cfg), cfg,
                                  mesh=mesh, local_loss=1.0)
        with pytest.raises(ValueError, match="unknown outer strategy"):
            bad = local_sgd.OuterConfig(strategy="bogus")
            local_sgd.outer_merge(p, local_sgd.OuterState.init(p, bad), bad,
                                  mesh=mesh)
    finally:
        dist.destroy_process_group()
