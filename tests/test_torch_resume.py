"""Checkpoint/resume in ``repro_torch.kg.fit`` (``ckpt_dir``,
``checkpoint_every``, ``resume``) and ``train/checkpoint.AsyncSaver``,
between the port's own runs and across the packages, on the CPU.

Between the port's runs the promise is bitwise: ``fit(4)`` equals
``fit(2)`` → checkpoint → ``fit(4, resume=True)``, params and loss
history.  Across the packages: the port's manifest holds the reference's
fields; the port resumes the reference's checkpoint on the reference's
replayed draws (``test_torch_mapreduce.replay_draws``) and lands within
rtol/atol 1e-5 of the reference's unbroken run (the training drift of
test_torch_mapreduce.py); and the reference's ``fit(resume=True)``
accepts a checkpoint the port wrote, landing as close to its own
unbroken run.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kg as ref_kg
from repro.core.models import get_model as ref_get_model
from repro.data import kg as ref_kg_lib
from repro.train import checkpoint as ref_ckpt
from repro_torch import kg as port_kg
from repro_torch.core import mapreduce
from repro_torch.data import kg as port_kg_lib
from repro_torch.train import checkpoint as port_ckpt

from test_torch_mapreduce import replay_draws
from test_torch_parity_helpers import TINY_KG, port_graph

TOL = dict(rtol=1e-5, atol=1e-5)
# batch 75 divides each of 2 workers' 750 triplets: no remainder warning
KW = dict(dim=8, batch_size=75, n_workers=2, learning_rate=0.05)
STEP2 = "step_0000000002"


def _fit(graph, **kw):
    return port_kg.fit(graph, device="cpu", **dict(KW, **kw))


def _manifest(ckpt_dir, step_dir):
    with open(os.path.join(ckpt_dir, step_dir, "manifest.json")) as f:
        return json.load(f)


def _steps(ckpt_dir):
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir))


def _same_run(got, want):
    assert got.loss_history == want.loss_history
    assert got.epochs_run == want.epochs_run
    for name in want.params:
        assert torch.equal(got.params[name], want.params[name]), name


@pytest.fixture(scope="module")
def graph():
    return port_kg_lib.synthetic_kg(0, **TINY_KG)


@pytest.mark.parametrize("sync", [False, True])
@pytest.mark.parametrize("paradigm", ["sgd", "bgd"])
def test_resume_is_bitwise(graph, tmp_path, paradigm, sync):
    full = _fit(graph, paradigm=paradigm, epochs=4)
    d = str(tmp_path / "ck")
    first = _fit(graph, paradigm=paradigm, epochs=2, ckpt_dir=d,
                 checkpoint_every=2, sync_checkpoints=sync)
    assert _steps(d) == [2]
    assert first.loss_history == full.loss_history[:2]
    seen = []
    resumed = _fit(graph, paradigm=paradigm, epochs=4, ckpt_dir=d,
                   resume=True, callback=lambda e, loss: seen.append(e))
    _same_run(resumed, full)
    assert seen == [2, 3]                   # absolute epochs, new ones only
    assert _steps(d) == [2, 4]
    assert _manifest(d, "step_0000000004")["extra"]["loss_history"] == \
        full.loss_history


def test_resume_of_a_warm_start(graph, tmp_path):
    """Caller params: the manifest records fresh_init False (the
    reference's rule) and the resume is still bitwise."""
    warm = {name: t * 0.5 for name, t in
            _fit(graph, epochs=1, seed=9).params.items()}
    full = _fit(graph, epochs=4, params=warm)
    d = str(tmp_path / "ck")
    _fit(graph, epochs=2, params=warm, ckpt_dir=d, checkpoint_every=2)
    assert _manifest(d, STEP2)["extra"]["fresh_init"] is False
    resumed = _fit(graph, epochs=4, ckpt_dir=d, resume=True)
    _same_run(resumed, full)
    # carried forward, not re-derived from the resumed call
    assert _manifest(d, "step_0000000004")["extra"]["fresh_init"] is False


def test_resume_with_bern_sampling_and_remainder(graph, tmp_path):
    """bern's head probabilities and the batching warning on both legs."""
    kw = dict(sampling="bern", batch_size=64)
    with pytest.warns(UserWarning, match="does not divide"):
        full = _fit(graph, epochs=3, **kw)
    d = str(tmp_path / "ck")
    with pytest.warns(UserWarning, match="does not divide"):
        _fit(graph, epochs=1, ckpt_dir=d, checkpoint_every=1, **kw)
    with pytest.warns(UserWarning, match="does not divide"):
        resumed = _fit(graph, epochs=3, ckpt_dir=d, resume=True, **kw)
    _same_run(resumed, full)


def test_resume_continues_the_trace_and_early_stop_is_saved(graph, tmp_path):
    d = str(tmp_path / "ck")
    _fit(graph, epochs=2, ckpt_dir=d, checkpoint_every=2)
    resumed = _fit(graph, epochs=4, ckpt_dir=d, resume=True, eval_every=1)
    assert resumed.trace.epochs() == [2, 3]
    traced = _fit(graph, epochs=4, eval_every=1)
    assert [e.metrics for e in resumed.trace.entries] == \
        [e.metrics for e in traced.trace.entries[2:]]
    # an early stop is checkpointed at the stopping epoch
    d2 = str(tmp_path / "stop")
    res = _fit(graph, epochs=8, eval_every=2, patience=1, learning_rate=0.0,
               ckpt_dir=d2, checkpoint_every=3)
    assert res.epochs_run == 4 and _steps(d2) == [3, 4]
    assert _manifest(d2, "step_0000000004")["extra"]["epoch"] == 4


def test_final_state_always_saved(graph, tmp_path):
    d1 = str(tmp_path / "end_only")
    _fit(graph, epochs=3, ckpt_dir=d1, sync_checkpoints=True)
    assert port_ckpt.latest_step(d1) == 3 and _steps(d1) == [3]
    d2 = str(tmp_path / "every1")
    _fit(graph, epochs=3, ckpt_dir=d2, checkpoint_every=1,
         keep_checkpoints=5)
    assert _steps(d2) == [1, 2, 3]
    d3 = str(tmp_path / "keep2")
    _fit(graph, epochs=3, ckpt_dir=d3, checkpoint_every=1,
         keep_checkpoints=2)
    assert _steps(d3) == [2, 3]


def test_resume_refusals(graph, tmp_path):
    d = str(tmp_path / "ck")
    _fit(graph, epochs=2, ckpt_dir=d, checkpoint_every=2)
    with pytest.raises(ValueError, match="seed: checkpoint has 0"):
        _fit(graph, epochs=4, seed=7, ckpt_dir=d, resume=True)
    other = port_kg_lib.synthetic_kg(3, **TINY_KG)
    with pytest.raises(ValueError, match="graph: checkpoint has"):
        _fit(other, epochs=4, ckpt_dir=d, resume=True)
    for change in (dict(paradigm="bgd"), dict(n_workers=3),
                   dict(learning_rate=0.1), dict(strategy="random")):
        with pytest.raises(ValueError, match="config: checkpoint has"):
            _fit(graph, epochs=4, ckpt_dir=d, resume=True, **change)
    with pytest.raises(ValueError, match="shape"):
        _fit(graph, epochs=4, dim=16, ckpt_dir=d, resume=True)
    with pytest.raises(ValueError, match="epochs"):
        _fit(graph, epochs=2, ckpt_dir=d, resume=True)
    with pytest.raises(FileNotFoundError):
        _fit(graph, epochs=4, ckpt_dir=str(tmp_path / "empty"), resume=True)
    with pytest.raises(ValueError, match="start_epoch"):
        mapreduce.train(graph, *port_kg.make_configs(graph, **KW), epochs=2,
                        start_epoch=-1, device="cpu")


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The reference's runs from its own init tables: unbroken for 4
    epochs, and for 2 with a checkpoint; the port's 2-epoch run from the
    same tables on the replayed draws, with a checkpoint."""
    root = tmp_path_factory.mktemp("cross")
    ref_graph = ref_kg_lib.synthetic_kg(0, **TINY_KG)
    graph = port_graph(ref_graph)
    kcfg, mcfg = ref_kg.make_configs(ref_graph, "transe", "sgd", **KW)
    init = ref_get_model("transe").init_params(jax.random.PRNGKey(1), kcfg)
    tables = {name: np.asarray(t) for name, t in init.items()}
    draws = replay_draws(ref_graph, kcfg, mcfg, tables, 0, 4)
    full = ref_kg.fit(ref_graph, epochs=4, params=init, **KW)
    ref_dir, port_dir = str(root / "ref"), str(root / "port")
    ref_kg.fit(ref_graph, epochs=2, params=init, ckpt_dir=ref_dir,
               checkpoint_every=2, sync_checkpoints=True, **KW)
    _fit(graph, epochs=2, params=tables, ckpt_dir=port_dir,
         checkpoint_every=2, draws=lambda epoch: draws[epoch])
    return dict(ref_graph=ref_graph, graph=graph, tables=tables,
                draws=draws, full=full, ref_dir=ref_dir, port_dir=port_dir,
                root=root)


def _close_to(got_params, got_history, want):
    np.testing.assert_allclose(got_history, want.loss_history, **TOL)
    for name in want.params:
        np.testing.assert_allclose(np.asarray(got_params[name]),
                                   np.asarray(want.params[name]), **TOL)


def test_manifest_fields_match_reference(cross):
    ref_m = _manifest(cross["ref_dir"], STEP2)
    port_m = _manifest(cross["port_dir"], STEP2)
    want, got = ref_m.pop("extra"), port_m.pop("extra")
    assert port_m == ref_m                     # step, has_opt
    assert list(got) == list(want)
    np.testing.assert_allclose(got.pop("loss_history"),
                               want.pop("loss_history"), **TOL)
    assert got == want
    assert got["config"] == mapreduce.resume_config(
        *port_kg.make_configs(cross["graph"], **KW))
    assert got["fresh_init"] is False and got["kind"] == "kg_train"
    with np.load(os.path.join(cross["ref_dir"], STEP2, "arrays.npz")) as r, \
            np.load(os.path.join(cross["port_dir"], STEP2,
                                 "arrays.npz")) as p:
        assert sorted(p.files) == sorted(r.files) == \
            ["params::ent", "params::rel"]
        for key in r.files:
            assert p[key].dtype == r[key].dtype == np.float32
            np.testing.assert_allclose(p[key], r[key], **TOL)


def test_port_resumes_reference_checkpoint(cross):
    d = str(cross["root"] / "ref_copy")
    shutil.copytree(cross["ref_dir"], d)
    draws = cross["draws"]
    got = _fit(cross["graph"], epochs=4, ckpt_dir=d, resume=True,
               draws=lambda epoch: draws[epoch])
    _close_to({n: t.numpy() for n, t in got.params.items()},
              got.loss_history, cross["full"])
    # the reference's first two losses ride through the manifest exactly
    assert got.loss_history[:2] == cross["full"].loss_history[:2]


def test_reference_resumes_port_checkpoint(cross):
    d = str(cross["root"] / "port_copy")
    shutil.copytree(cross["port_dir"], d)
    got = ref_kg.fit(cross["ref_graph"], epochs=4, ckpt_dir=d, resume=True,
                     sync_checkpoints=True, **KW)
    _close_to(got.params, got.loss_history, cross["full"])


# ---------------------------------------------------------------------------
# The saver and the templated restore
# ---------------------------------------------------------------------------

def test_async_saver_snapshots_before_returning(tmp_path):
    d = str(tmp_path)
    table = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    saver = port_ckpt.AsyncSaver()
    saver.save_async(d, 1, {"ent": table}, extra={"epoch": 1})
    table += 100.0                 # the caller goes on changing its tensor
    saver.wait()
    step, tree, extra = port_ckpt.restore(d)
    assert step == 1 and extra == {"epoch": 1}
    np.testing.assert_array_equal(tree["ent"], np.arange(6).reshape(2, 3))
    # the same bytes as a synchronous save
    port_ckpt.save(str(tmp_path / "sync"), 1,
                   {"ent": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
                   extra={"epoch": 1})
    with np.load(os.path.join(d, "step_0000000001", "arrays.npz")) as a, \
            np.load(str(tmp_path / "sync" / "step_0000000001" /
                        "arrays.npz")) as b:
        assert a["params::ent"].tobytes() == b["params::ent"].tobytes()


def test_async_saver_error_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = port_ckpt.AsyncSaver()
    saver.save_async(str(blocker / "ck"), 1, {"w": np.zeros(2)})
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()                             # raised once, then clear


def test_templated_restore_checks_leaves(tmp_path):
    d = str(tmp_path)
    port_ckpt.save(d, 1, {"ent": np.ones((4, 3), np.float32),
                          "rel": np.ones((2, 3), np.float32)})
    meta = lambda *shape: torch.empty(shape, device="meta")
    _, tree, _ = port_ckpt.restore(
        d, params_template={"ent": meta(4, 3), "rel": meta(2, 3)})
    assert tree["ent"].dtype == torch.float32 and tree["ent"].shape == (4, 3)
    _, tree, _ = port_ckpt.restore(d, params_template={
        "ent": torch.empty(4, 3, dtype=torch.float64)})
    assert tree["ent"].dtype == torch.float64 and set(tree) == {"ent"}
    with pytest.raises(ValueError, match="'params::rel' has shape"):
        port_ckpt.restore(d, params_template={"ent": meta(4, 3),
                                              "rel": meta(5, 3)})
    with pytest.raises(KeyError, match="params::ent"):
        port_ckpt.restore(d, params_template={"norm": meta(2, 3)})


def test_raw_bf16_arrays_are_refused_as_by_the_reference(tmp_path):
    """A bf16 table saved by the reference reloads as ``|V2``; its
    templated restore cannot cast that, and neither can the port's."""
    d = str(tmp_path)
    ref_ckpt.save(d, 1, {"ent": jnp.ones((4, 3), jnp.bfloat16)})
    with pytest.raises(ValueError):
        ref_ckpt.restore(d, params_template={
            "ent": jax.ShapeDtypeStruct((4, 3), jnp.float32)})
    with pytest.raises(ValueError, match="raw 2-byte values"):
        port_ckpt.restore(d, params_template={
            "ent": torch.empty(4, 3, device="meta")})
