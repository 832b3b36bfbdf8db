"""The port's launcher (``repro_torch.launch.train``) and its three KG
examples (``examples/torch_*.py``), on the CPU.

Against the reference launcher: the flag set (every ``--kg*`` flag, ``--lr``
and ``--seed`` with the same default, type, choices, metavar and help,
captured from the reference's ``main`` at ``parse_args``) and its eight
``SystemExit`` texts on the same argv.  Against a direct
``repro_torch.kg.fit``: the launcher's checkpoint, bitwise, in process and
through ``python -m``; ``--kg-dataset`` on a ``datasets.write_tsv`` file,
``--kg-update`` against a direct ``kb.update`` and ``--kg-serve``.  Then a
smoke run of each example at a tiny size.
"""
import argparse
import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import train as ref_train
from repro_torch import kg as port_kg
from repro_torch.data import datasets as port_datasets
from repro_torch.data import kg as port_kg_lib
from repro_torch.launch import train as port_train
from repro_torch.train import checkpoint as port_ckpt

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SMALL = ["--kg-entities", "300", "--kg-triplets", "2500", "--kg-epochs", "2",
         "--kg-workers", "2"]
DEVICE = ["--device", "cpu"]


class _Captured(Exception):
    pass


def _reference_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser the reference's ``main`` builds, taken at its
    ``parse_args`` call."""
    def capture(self, args=None, namespace=None):
        raise _Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured) as got:
        ref_train.main(["--kg", "transe"])
    monkeypatch.undo()
    return got.value.args[0]


def _actions(parser) -> dict:
    return {a.option_strings[-1]: a for a in parser._actions
            if a.option_strings and a.option_strings[-1] != "--help"}


FIELDS = ("dest", "default", "type", "choices", "metavar", "help", "nargs",
          "const", "required")


def test_flags_match_the_reference(monkeypatch):
    ref = _actions(_reference_parser(monkeypatch))
    port = _actions(port_train.build_parser())
    assert set(port) == set(ref) | {"--device"}
    shared = [f for f in ref if f.startswith("--kg") or f in ("--lr",
                                                              "--seed")]
    assert len(shared) == 33
    for flag in shared:
        for field in FIELDS:
            assert getattr(port[flag], field) == getattr(ref[flag], field), \
                (flag, field)
        assert type(port[flag]) is type(ref[flag]), flag
    # the LM flags keep their defaults and are refused with --arch
    for flag in ("--reduced", "--steps", "--batch", "--seq", "--optimizer",
                 "--microbatches", "--ckpt-dir", "--ckpt-every", "--mesh"):
        assert port[flag].default == ref[flag].default, flag
    assert port["--device"].default == "cuda"


def test_help_lists_every_flag():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--help"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr
    for flag in _actions(port_train.build_parser()):
        assert flag in out.stdout


def _exit_text(main, argv) -> str:
    with pytest.raises(SystemExit) as got:
        main(argv)
    return str(got.value.code)


TINY = ["--kg-entities", "60", "--kg-triplets", "600", "--kg-epochs", "1",
        "--kg-workers", "1"]


@pytest.mark.filterwarnings("ignore:batch_size=256 does not divide")
@pytest.mark.parametrize("argv,start", [
    (["--kg-block-epochs", "2"], "--kg-block-epochs / --kg-merge-every"),
    (["--kg-merge-every", "2"], "--kg-block-epochs / --kg-merge-every"),
    (["--kg-patience", "2"], "--kg-patience / --kg-trace-out"),
    (["--kg-checkpoint-every", "2"], "--kg-checkpoint-every / --kg-resume"),
    (["--kg-staleness", "1"], "--kg-staleness is the bounded-staleness"),
    (["--kg-refresh-every", "5"], "--kg-refresh-every streams"),
    (["--kg-refresh-every", "5", "--kg-update", "DELTA"],
     "--kg-refresh-every refreshes a live server"),
])
def test_system_exit_texts_match_the_reference(tmp_path, argv, start):
    """Each refusal of ``_run_kg``, against the reference's ``main`` on the
    same argv (the refresh ones after a one-step training run)."""
    delta = tmp_path / "delta.tsv"
    delta.write_text("0\t0\t1\n")
    argv = ["--kg", "transe"] + TINY + [
        str(delta) if a == "DELTA" else a for a in argv]
    want = _exit_text(ref_train.main, argv)
    assert want.startswith(start)
    assert _exit_text(port_train.main, argv + DEVICE) == want


@pytest.mark.parametrize("text,start", [
    ("", "--kg-update"), ("a\tb\tc\n", "--kg-update")])
def test_read_delta_exit_texts_match_the_reference(tmp_path, text, start):
    """``_read_delta``'s two refusals: no triples, string names."""
    path = tmp_path / "delta.tsv"
    path.write_text(text)
    want = _exit_text(ref_train._read_delta, str(path))
    assert want.startswith(start) and want.replace(str(path), "") != want
    assert _exit_text(port_train._read_delta, str(path)) == want


FINAL_LINE = re.compile(r"^final loss: (\d+\.\d{4}) \(start (\d+\.\d{4})\)$")


def test_arch_is_item_16(capsys):
    """``--arch`` (item 16e) trains: the reference's last line, in the
    reference's form (the two packages' inits differ, so the numbers
    do), one logged line every ``steps // 20`` steps, and the history
    the trainer returns.  ``[]`` still exits with code 2, and the LM
    mesh (item 16f) on one process raises ``ValueError`` in both
    packages, the port's naming the 256 ranks a pod mesh needs."""
    argv = ["--arch", "smollm-135m", "--reduced", "--steps", "5"]
    trainer = port_train.main(argv + DEVICE)
    port_lines = capsys.readouterr().out.strip().splitlines()
    ref_train.main(argv)
    ref_lines = capsys.readouterr().out.strip().splitlines()
    assert len(port_lines) == len(ref_lines) == 6
    m = FINAL_LINE.match(port_lines[-1])
    assert m and FINAL_LINE.match(ref_lines[-1]), (port_lines, ref_lines)
    assert float(m.group(1)) == round(trainer.history[-1], 4)
    assert float(m.group(2)) == round(trainer.history[0], 4)
    for p, r in zip(port_lines[:-1], ref_lines[:-1]):
        assert p.split(":")[0] == r.split(":")[0]        # "step N"
    with pytest.raises(SystemExit) as got:
        port_train.main([])
    assert got.value.code == 2
    with pytest.raises(ValueError, match="needs 256 ranks"):
        port_train.main(argv + DEVICE + ["--mesh", "pod"])
    with pytest.raises(ValueError):
        ref_train.main(argv + ["--mesh", "pod"])


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-mistral-7b"])
def test_multimodal_archs_exit_with_the_reference_text(arch):
    argv = ["--arch", arch, "--reduced", "--steps", "1"]
    want = _exit_text(ref_train.main, argv)
    assert want.startswith("this CLI trains token-LM archs")
    assert _exit_text(port_train.main, argv + DEVICE) == want


def _direct_fit(graph, **kw):
    return port_kg.fit(
        graph, model="transe", paradigm="sgd", n_workers=2,
        strategy="average", merge_transport="dense",
        table_sharding="replicated", partitioner=None, staleness=0,
        negatives="pertriplet", neg_candidates=0, backend="vmap",
        batch_size=256, dim=48, learning_rate=5e-2, epochs=2, seed=0,
        device="cpu", **kw)


def _checkpoint(path) -> dict:
    step = port_ckpt.latest_step(str(path))
    tree, extra = port_ckpt.load_tree(str(path), step)
    return tree, extra


@pytest.mark.filterwarnings("ignore:batch_size=256 does not divide")
def test_checkpoint_equals_a_direct_fit(tmp_path, capsys):
    """``main`` in process and ``python -m`` write the checkpoint of a
    direct ``kg.fit`` with the same arguments, bitwise."""
    argv = ["--kg", "transe"] + SMALL + DEVICE
    port_train.main(argv + ["--kg-ckpt-dir", str(tmp_path / "a")])
    printed = capsys.readouterr().out
    graph = port_kg_lib.synthetic_kg(0, n_entities=300, n_relations=15,
                                     n_triplets=2500)
    want = _direct_fit(graph)
    tree, extra = _checkpoint(tmp_path / "a")
    for name, t in want.params.items():
        assert np.asarray(tree[name]).tobytes() == t.numpy().tobytes()
    assert extra["loss_history"] == want.loss_history
    final = [line for line in printed.splitlines() if "final loss" in line]
    assert final == [f"[transe/sgd/host] final loss: "
                     f"{want.loss_history[-1]:.4f} (start "
                     f"{want.loss_history[0]:.4f}) after 2 epochs"]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train"] + argv
        + ["--kg-ckpt-dir", str(tmp_path / "b")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr
    assert final[0] in out.stdout
    tree_b, _ = _checkpoint(tmp_path / "b")
    for name in want.params:
        assert np.asarray(tree_b[name]).tobytes() == \
            np.asarray(tree[name]).tobytes()


@pytest.mark.filterwarnings("ignore:batch_size=256 does not divide")
def test_dataset_update_and_serve(tmp_path, capsys):
    """``--kg-dataset`` on a written TSV directory against a direct fit on
    the loaded graph; ``--kg-update`` against a direct ``kb.update``;
    ``--kg-serve`` answers its requests with no steady-state recompile."""
    graph = port_kg_lib.synthetic_kg(3, n_entities=300, n_relations=15,
                                     n_triplets=2500)
    data = tmp_path / "data"
    data.mkdir()
    for split in ("train", "valid", "test"):
        port_datasets.write_tsv(str(data / f"{split}.txt"),
                                getattr(graph, split))
    delta = np.array([[1, 2, 3], [4, 0, 5], [299, 1, 300]], np.int32)
    (tmp_path / "delta.tsv").write_text(
        "".join(f"{h}\t{r}\t{t}\n" for h, r, t in delta))
    port_train.main(["--kg", "transe", "--kg-dataset", str(data),
                     "--kg-update", str(tmp_path / "delta.tsv"),
                     "--kg-serve", "--kg-requests", "20", "--kg-qps",
                     "1000"] + SMALL + DEVICE)
    printed = capsys.readouterr().out
    loaded = port_datasets.load_dataset(str(data), seed=0)
    res = _direct_fit(loaded)
    updated = res.kb.update(delta, epochs=8, n_workers=2, learning_rate=5e-2,
                            seed=0)
    assert f"loaded {data}: {loaded.n_entities} entities" in printed
    assert (f"applied --kg-update {tmp_path / 'delta.tsv'}: 3 triples, "
            f"{loaded.n_entities} -> {updated.n_entities} entities, "
            f"[kb={updated.fingerprint()}]") in printed.replace(
                f"{loaded.n_relations} -> {updated.n_relations} relations ",
                "")
    served = [line for line in printed.splitlines()
              if line.startswith("served 20 queries")]
    assert len(served) == 1 and "steady_recompiles=0" in served[0]
    assert printed.count(f"[kb={updated.fingerprint()} cached=") == 3


def _run_example(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(os.path.join(ROOT, "examples", name), run_name="__main__")


@pytest.mark.filterwarnings("ignore:batch_size=256 does not divide")
def test_quickstart_example(monkeypatch, tmp_path, capsys):
    """The quickstart at a tiny graph (its size is fixed in the script:
    its graph is cut to a small one here)."""
    real = port_kg_lib.synthetic_kg
    monkeypatch.setattr(
        port_kg_lib, "synthetic_kg",
        lambda seed, n_entities, n_relations, n_triplets: real(
            seed, n_entities=120, n_relations=n_relations, n_triplets=900))
    _run_example(monkeypatch, "torch_quickstart.py",
                 ["--device", "cpu", "--save-dir", str(tmp_path / "kb")])
    out = capsys.readouterr().out
    assert "entity inference (filtered): mean_rank=" in out
    assert "model=transe entities=120" in out
    assert out.count("-> [") == 6
    assert os.path.isdir(tmp_path / "kb")


@pytest.mark.filterwarnings("ignore:batch_size=256 does not divide")
def test_train_mapreduce_kg_example(monkeypatch, capsys):
    _run_example(monkeypatch, "torch_train_mapreduce_kg.py", [
        "--epochs", "2", "--entities", "120", "--triplets", "2400",
        "--workers", "2", "--dim", "8", "--eval-every", "1", "--device",
        "cpu"])
    out = capsys.readouterr().out
    for name in ("single-thread", "bgd-W2", "sgd-average-W2",
                 "sgd-miniloss-W2", "sgd-random-W2"):
        assert out.count(f"  {name:26s}") == 1 and f"{name:26s} loss=" in out
    assert out.count("MR curve (epoch:MR)") == 5


@pytest.mark.filterwarnings("ignore:batch_size=256 does not divide")
def test_online_update_example(monkeypatch, tmp_path, capsys):
    _run_example(monkeypatch, "torch_online_update.py", [
        "--epochs", "2", "--update-epochs", "1", "--entities", "120",
        "--triplets", "2400", "--dim", "8", "--workers", "2",
        "--chain-dir", str(tmp_path / "chain"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(bit-identical)" in out and out.count("update ") == 2
    assert "served 50 queries across the refresh" in out
    assert "steady_recompiles=0" in out


def test_device_defaults_to_the_card():
    """Without ``--device`` the launcher runs on the card, and raises
    where there is none rather than running on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(["--kg", "transe"] + TINY)
