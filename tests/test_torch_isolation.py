"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor
anything of ``repro``, and its entry points never drop to the CPU
unasked."""
import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert, kg, resolve_device
from repro_torch.core import models
from repro_torch.data import kg as kg_data
from repro_torch.kb import KnowledgeBase

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG_DIR = os.path.dirname(repro_torch.__file__)


def _port_modules():
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG_DIR], "repro_torch.")]


def test_every_module_imports_without_jax():
    """A fresh interpreter in which ``import jax`` fails imports every
    module of the port."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert len(_port_modules()) >= 40
    for name in ("repro_torch.serve.server", "repro_torch.core.transe",
                 "repro_torch.core.models.transh",
                 "repro_torch.core.models.distmult",
                 "repro_torch.online.updater", "repro_torch.data.datasets",
                 "repro_torch.parallel.sharding"):
        assert name in _port_modules()


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [os.path.join(dp, f) for dp, _, fs in os.walk(
        os.path.join(ROOT, "src", "repro_torch")) for f in fs
     if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py"),
                              os.path.join(ROOT, "tools",
                                           "profile_torch_eval.py"),
                              os.path.join(ROOT, "tests",
                                           "test_torch_rank_worker.py")]
    + [os.path.join(ROOT, "examples", f) for f in (
        "torch_quickstart.py", "torch_train_mapreduce_kg.py",
        "torch_online_update.py")]),
    ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import_in_source(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (
            f"{os.path.relpath(path, ROOT)} imports {name}")


def test_entry_points_need_a_device_without_cuda(monkeypatch, tmp_path):
    """Without a GPU, an entry point called without ``device=`` raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tables = {"ent": np.zeros((4, 2), np.float32),
              "rel": np.zeros((2, 2), np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_reference(tables)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.get_model("transe").init_params(
            torch.Generator(), models.KGConfig(4, 2, dim=2))
    kb = convert.kb_from_reference(tables, device="cpu")
    kb.save(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KnowledgeBase.load(str(tmp_path))
    assert KnowledgeBase.load(str(tmp_path), device="cpu").n_entities == 4
    graph = kg_data.synthetic_kg(0, n_entities=40, n_relations=2,
                                 n_triplets=200)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kg.fit(graph, epochs=1, dim=4, batch_size=16, n_workers=2)
    ckpt = str(tmp_path / "ckpt")
    assert kg.fit(graph, epochs=1, dim=4, batch_size=16, n_workers=2,
                  ckpt_dir=ckpt, device="cpu").kb.params["ent"].device.type \
        == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kg.fit(graph, epochs=2, dim=4, batch_size=16, n_workers=2,
               ckpt_dir=ckpt, resume=True)
