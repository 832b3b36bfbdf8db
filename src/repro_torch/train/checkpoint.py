"""Checkpoints in the reference's on-disk format (port of
``repro.train.checkpoint``: full saves of a params tree and, for LM
training, its optimizer state, synchronous or through
:class:`AsyncSaver`, and delta chains).

Layout:  ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, written to a
``.tmp`` sibling then ``os.rename``d, so a crash mid-write never leaves a
half-readable "latest" checkpoint.  ``arrays.npz`` keys are
``params::<path>`` with ``/``-joined dict keys (``params::params/ent``),
exactly as the reference writes them: artifacts cross between the two
packages both ways.  An optimizer state is stored beside the params as
``opt::<path>`` (``opt::m/embed.table``), and the manifest's ``has_opt``
says whether one was saved.  Arrays are stored as full host values;
``restore`` rebuilds nested dicts of numpy arrays (or, given a template,
CPU tensors of the template's dtypes), and the caller places them on a
device.

bfloat16: numpy has no such type without ``ml_dtypes``, and the reference
saves a bf16 table as its raw 2-byte values, which ``np.load`` reads back
as ``|V2`` void arrays.  The port writes a bf16 tensor the same way (the
values' bytes as ``|V2``; the ``.npy`` header spells the reference's
``<V2`` as ``|V2``, which numpy reads the same).  Neither package can
serve such an array after loading it: the reference's untemplated
restore returns it as ``|V2`` and its templated restore raises; the
port's templated restore raises too (:func:`restore`).

Delta chains: :func:`save_delta` appends a *delta* step holding only the
rows an online update changed or appended (plus the delta's triples)
against the chain tip.  A chain directory is one full base artifact at
its first step followed by delta steps, each manifest naming the
fingerprint it applies to (``base``) and the one it produces
(``result``).  A delta saved into a directory whose tip is another
artifact raises before any byte lands, synchronously in
``AsyncSaver.save_delta_async`` too.  No cleanup ever runs on a chain
(every link is needed to replay it), and :func:`restore` refuses delta
steps: ``KnowledgeBase.load_chain`` replays them.  Chains cross between
the two packages both ways.
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
    opt_state=None,
    extra: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> str:
    """Synchronous atomic save of the tree ``params`` (and the tree
    ``opt_state``, where given), keeping the newest ``keep`` steps.
    Returns the committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {}
    for name, tree in (("params", params), ("opt", opt_state)):
        if tree is None:
            continue
        for k, v in _flatten_with_paths(tree).items():
            arrays[f"{name}::{k}"] = v
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "extra": extra or {},
                "has_opt": opt_state is not None}
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

    def save_async(self, ckpt_dir: str, step: int, params, opt_state=None,
                   extra: Optional[Dict[str, Any]] = None, keep: int = 3):
        self.wait()
        host_params = _to_host(params)
        host_opt = None if opt_state is None else _to_host(opt_state)

        def run():
            try:
                save(ckpt_dir, step, host_params, host_opt, extra, keep)
            except Exception as e:                    # raised by wait()
                self.last_error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def save_delta_async(self, ckpt_dir: str, tree, extra: Dict[str, Any],
                         step: Optional[int] = None):
        """:func:`save_delta` with the disk I/O on the thread; the manifest
        keys and the chain tip are checked here, so a mismatched base
        raises in the caller's frame, not at a later :meth:`wait`."""
        self.wait()
        _check_delta(ckpt_dir, extra)
        host_tree = _to_host(tree)

        def run():
            try:
                save_delta(ckpt_dir, host_tree, extra, step=step)
            except Exception as e:                    # raised by wait()
                self.last_error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()


DELTA_KIND = "kb_delta"


def chain_steps(ckpt_dir: str) -> list:
    """Committed step numbers in a chain directory, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")))


def chain_tip_fingerprint(ckpt_dir: str) -> Optional[str]:
    """Fingerprint of the artifact the chain builds to: the latest step's
    ``fingerprint`` (a base artifact) or ``result`` (a delta).  None for an
    empty or missing directory; raises for an artifact saved without a
    fingerprint."""
    steps = chain_steps(ckpt_dir)
    if not steps:
        return None
    extra = _read_manifest(ckpt_dir, steps[-1]).get("extra") or {}
    fp = extra.get("result") if extra.get("delta") else extra.get(
        "fingerprint")
    if fp is None:
        raise ValueError(
            f"checkpoint at {ckpt_dir} step {steps[-1]} carries no "
            "fingerprint — saved before delta chains existed?  Re-save the "
            "base artifact to start a chain.")
    return fp


def _check_delta(ckpt_dir: str, extra: Dict[str, Any]) -> None:
    """A delta's manifest names ``delta``, ``base`` and ``result``, and
    ``base`` is the chain tip's fingerprint."""
    for key in ("delta", "base", "result"):
        if not extra.get(key):
            raise ValueError(
                f"delta manifest must set {key!r} (got extra={extra!r})")
    tip = chain_tip_fingerprint(ckpt_dir)
    if tip is None:
        raise FileNotFoundError(
            f"no base artifact in {ckpt_dir} — save the base with "
            "KnowledgeBase.save before appending deltas")
    if tip != extra["base"]:
        raise ValueError(
            f"delta applies to fingerprint {extra['base']} but the chain "
            f"tip at {ckpt_dir} is {tip} — unrelated base artifact?")


def save_delta(
    ckpt_dir: str,
    tree,
    extra: Dict[str, Any],
    step: Optional[int] = None,
) -> str:
    """Append a delta step (the tree under ``params::``) to a chain
    directory and return the committed directory.  ``extra`` must carry
    ``delta=True``, ``base`` (the fingerprint the delta applies to, which
    must be the chain tip's) and ``result``; a mismatch raises before any
    byte lands.  ``step`` defaults to the tip's plus one; no cleanup
    runs."""
    _check_delta(ckpt_dir, extra)
    if step is None:
        step = chain_steps(ckpt_dir)[-1] + 1
    final = _step_dir(ckpt_dir, step)
    if os.path.exists(final):
        raise FileExistsError(f"chain step already committed: {final}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {f"params::{k}": v
              for k, v in _flatten_with_paths(tree).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "extra": extra, "has_opt": False}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)
    return final


def _read_manifest(ckpt_dir: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(_step_dir(ckpt_dir, step), "manifest.json")) as f:
        return json.load(f)


def load_tree(ckpt_dir: str, step: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Raw (params tree, extra) of one step — nested dicts of host arrays,
    no validation; what ``KnowledgeBase.load_chain`` replays deltas
    with."""
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
    steps = chain_steps(ckpt_dir)
    return steps[-1] if steps else None


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


def _from_template(d: str, z, template, prefix: str) -> Dict[str, Any]:
    """The stored ``prefix::`` arrays at ``template``'s leaf paths, each
    checked against its template leaf and cast to the leaf's dtype as a
    CPU tensor."""
    flat = {}
    for path, leaf in _leaves(template):
        key = f"{prefix}::{path}"
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
    opt_template=None,
) -> Tuple:
    """Restore ``(step, params, extra)``, or, given ``opt_template``,
    ``(step, params, opt, extra)`` as the reference's ``restore`` returns
    it: ``opt`` the stored optimizer state read at ``opt_template``'s
    paths as the params are read at ``params_template``'s, or None for a
    checkpoint saved without one (``has_opt`` false, as every KG
    checkpoint is).  ``step=None`` takes the latest committed step;
    ``expect`` compares manifest ``extra`` fields (:func:`validate_extra`).
    A delta
    step is refused: no resume ever starts from one, and
    ``KnowledgeBase.load_chain`` replays a chain.

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
            f"{d} is a delta step, not a full checkpoint — replay the "
            "chain with KnowledgeBase.load_chain instead of restore()")
    if expect:
        validate_extra(extra, expect, d)
    if params_template is None:
        tree, _ = load_tree(ckpt_dir, step)
    else:
        with np.load(os.path.join(d, "arrays.npz")) as z:
            tree = _from_template(d, z, params_template, "params")
    if opt_template is None:
        return step, tree, extra
    opt = None
    if manifest.get("has_opt"):
        with np.load(os.path.join(d, "arrays.npz")) as z:
            opt = _from_template(d, z, opt_template, "opt")
    return step, tree, opt, extra
