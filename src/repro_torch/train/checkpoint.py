"""Checkpoints in the reference's on-disk format (port of
``repro.train.checkpoint``: full saves of a params tree, synchronous or
through :class:`AsyncSaver`; no optimizer state or delta chains yet).

Layout:  ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, written to a
``.tmp`` sibling then ``os.rename``d, so a crash mid-write never leaves a
half-readable "latest" checkpoint.  ``arrays.npz`` keys are
``params::<path>`` with ``/``-joined dict keys (``params::params/ent``),
exactly as the reference writes them: artifacts cross between the two
packages both ways.  Arrays are stored as full host values; ``restore``
rebuilds nested dicts of numpy arrays (or, given a template, CPU tensors of
the template's dtypes), and the caller places them on a device.

bfloat16: numpy has no such type without ``ml_dtypes``, and the reference
saves a bf16 table as its raw 2-byte values, which ``np.load`` reads back
as ``|V2`` void arrays.  The port writes a bf16 tensor the same way (the
values' bytes as ``|V2``; the ``.npy`` header spells the reference's
``<V2`` as ``|V2``, which numpy reads the same).  Neither package can
serve such an array after loading it: the reference's untemplated
restore returns it as ``|V2`` and its templated restore raises; the
port's templated restore raises too (:func:`restore`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _host(leaf) -> np.ndarray:
    """A copy of ``leaf`` as a host numpy array that no later write to the
    leaf can change; a bf16 tensor as its raw 2-byte values (``|V2``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(leaf)


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``("a/b", leaf)`` for every leaf of a tree of dicts, lists and
    tuples, in the reference's path spelling (dict keys in sorted order,
    sequence positions as their index)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from _leaves(sub, f"{prefix}/{key}" if prefix else key)


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    """``{"a/b": host array}`` for every leaf of ``tree``."""
    return {path: _host(leaf) for path, leaf in _leaves(tree)}


def _to_host(tree):
    """``tree`` with every leaf copied to a host numpy array."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return _host(tree)


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


class AsyncSaver:
    """Snapshot to the host synchronously, write to disk on a daemon
    thread, one save in flight at a time.

    ``save_async`` copies every leaf to a host numpy array before it
    returns (a CUDA tensor through a synchronous ``.cpu()`` copy), so the
    caller may go on changing its tensors and the thread never touches
    one.  An error in the thread is raised by the next :meth:`wait` (which
    the next ``save_async`` calls first)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save_async(self, ckpt_dir: str, step: int, params,
                   extra: Optional[Dict[str, Any]] = None, keep: int = 3):
        self.wait()
        host_params = _to_host(params)

        def run():
            try:
                save(ckpt_dir, step, host_params, extra, keep)
            except Exception as e:                    # raised by wait()
                self.last_error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()


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


def _from_template(d: str, z, template) -> Dict[str, Any]:
    """The stored arrays at ``template``'s leaf paths, each checked
    against its template leaf and cast to the leaf's dtype as a CPU
    tensor."""
    flat = {}
    for path, leaf in _leaves(template):
        key = f"params::{path}"
        if key not in z.files:
            raise KeyError(
                f"checkpoint {d} has no array {key!r} (stored: "
                f"{sorted(z.files)}) — saved by a different model?")
        arr = z[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint array {key!r} has shape {tuple(arr.shape)} but "
                f"the template expects {tuple(leaf.shape)} — checkpoint "
                "from a different model or config?")
        if arr.dtype.kind == "V":
            raise ValueError(
                f"checkpoint array {key!r} holds raw {arr.dtype.itemsize}-"
                f"byte values ({arr.dtype.str}), not numbers: a bfloat16 "
                "table as numpy writes it, which cannot be cast to "
                f"{leaf.dtype} (the reference's restore refuses it too)")
        flat[path] = torch.from_numpy(arr).to(leaf.dtype)
    return _nest_flat(flat)


def restore(
    ckpt_dir: str,
    step: Optional[int] = None,
    expect: Optional[Dict[str, Any]] = None,
    params_template=None,
) -> Tuple[int, Any, Dict[str, Any]]:
    """Restore ``(step, params, extra)`` (stored optimizer state is not
    read).  ``step=None`` takes the latest committed step; ``expect``
    compares manifest ``extra`` fields (:func:`validate_extra`).  A delta
    step of a reference delta chain is refused: the port cannot replay
    chains yet.

    Without ``params_template`` the params tree is rebuilt self-describing
    from the stored paths (nested dicts of host arrays).  With one (a tree
    of tensors on any device, ``meta`` included, giving structure, shapes
    and dtypes) every template leaf must be stored, with the leaf's shape:
    a missing array raises ``KeyError`` naming the stored keys, a shape
    mismatch ``ValueError`` naming the leaf; the leaves come back as CPU
    tensors of the template's dtypes."""
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
    if params_template is None:
        tree, _ = load_tree(ckpt_dir, step)
        return step, tree, extra
    with np.load(os.path.join(d, "arrays.npz")) as z:
        return step, _from_template(d, z, params_template), extra
