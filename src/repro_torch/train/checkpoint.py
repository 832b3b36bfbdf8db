"""Checkpoints in the reference's on-disk format (port of
``repro.train.checkpoint``: synchronous full saves of a params tree; no
optimizer state, async saver or delta chains yet).

Layout:  ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, written to a
``.tmp`` sibling then ``os.rename``d, so a crash mid-write never leaves a
half-readable "latest" checkpoint.  ``arrays.npz`` keys are
``params::<path>`` with ``/``-joined dict keys (``params::params/ent``),
exactly as the reference writes them: artifacts cross between the two
packages both ways.  Arrays are stored as full host values; ``restore``
rebuilds nested dicts of numpy arrays, and the caller places them on a
device.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a/b": array}`` for every leaf of a tree of dicts, lists and
    tuples, in the reference's path spelling (dict keys in sorted order,
    sequence positions as their index)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: _host(tree)}
    flat = {}
    for key, sub in items:
        flat.update(_flatten_with_paths(
            sub, f"{prefix}/{key}" if prefix else key))
    return flat


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def save(
    ckpt_dir: str,
    step: int,
    params,
    extra: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> str:
    """Synchronous atomic save of the tree ``params``, keeping the newest
    ``keep`` steps.  Returns the committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {f"params::{k}": v
              for k, v in _flatten_with_paths(params).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "extra": extra or {}, "has_opt": False}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _cleanup(ckpt_dir, keep)
    return final


def _read_manifest(ckpt_dir: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(_step_dir(ckpt_dir, step), "manifest.json")) as f:
        return json.load(f)


def load_tree(ckpt_dir: str, step: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Raw (params tree, extra) of one step — nested dicts of host arrays,
    no validation."""
    manifest = _read_manifest(ckpt_dir, step)
    with np.load(os.path.join(_step_dir(ckpt_dir, step), "arrays.npz")) as z:
        flat = {k[len("params::"):]: z[k] for k in z.files
                if k.startswith("params::")}
    return _nest_flat(flat), manifest.get("extra") or {}


def _cleanup(ckpt_dir: str, keep: int):
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def validate_extra(
    extra: Dict[str, Any], expect: Dict[str, Any], where: str
) -> None:
    """Compare manifest ``extra`` fields against expected values and raise
    one clear error naming every mismatch (a cross-model or cross-graph
    load fails here instead of giving silently wrong numbers)."""
    problems = []
    for key, want in expect.items():
        got = extra.get(key)
        if got != want:
            problems.append(f"{key}: checkpoint has {got!r}, expected {want!r}")
    if problems:
        raise ValueError(
            f"checkpoint manifest at {where} does not match this run — "
            + "; ".join(problems)
            + " — checkpoint from a different model/config?")


def _nest_flat(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Rebuild a nested dict from '/'-joined path keys (sequence nodes come
    back as dicts keyed by their stringified index)."""
    out: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def restore(
    ckpt_dir: str,
    step: Optional[int] = None,
    expect: Optional[Dict[str, Any]] = None,
) -> Tuple[int, Any, Dict[str, Any]]:
    """Restore ``(step, params, extra)``, the params tree rebuilt
    self-describing from the stored paths (nested dicts of host arrays;
    stored optimizer state is not read).  ``step=None`` takes the latest
    committed step; ``expect`` compares manifest ``extra`` fields
    (:func:`validate_extra`).  A delta step of a reference delta chain is
    refused: the port cannot replay chains yet."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    manifest = _read_manifest(ckpt_dir, step)
    extra = manifest.get("extra") or {}
    if extra.get("delta"):
        raise ValueError(
            f"{d} is a delta step, not a full checkpoint — repro_torch "
            "cannot replay delta chains yet (ROADMAP.md queue 1, item 14)")
    if expect:
        validate_extra(extra, expect, d)
    tree, _ = load_tree(ckpt_dir, step)
    return step, tree, extra
