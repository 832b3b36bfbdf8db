"""Fused TransE triplet scoring, forward and backward: the wrappers of the
CUDA kernels ``csrc/transe_score.cu`` (port of
``repro.kernels.transe_score`` and of the backward of
``repro.kernels.ops.fused_margin_loss``).

The paper's training hot spot is the per-triplet update: gather the five
rows (h, r, t, corrupted h, corrupted t), take ``u = h + r - t`` and
``v = nh + r - nt``, their distances, the hinge; and, backward, scatter
``±s(u)``, ``±s(v)`` into the tables' gradients.

Tables are ``(E, k)`` / ``(R, k)`` with triplets ``(B, 5)``, or stacked
per worker, ``(W, E, k)`` / ``(W, R, k)`` with triplets ``(W, B, 5)`` of
each worker's own ids: one launch serves all W workers.  A stacked table
may be W separate copies (SGD's local tables) or one table expanded with
worker stride 0 (BGD's shared table, ``table.expand(W, E, k)``); the
gradients are dense ``(W, E, k)`` either way, one slice per worker.

On CPU tensors the wrappers compute the plain versions
(``ref.transe_score_ref``, ``ref.transe_score_bwd_ref``); on CUDA tensors
they launch the kernels or raise — there is no fallback between the two.
``transe_score.launches`` and ``transe_score_bwd.launches`` count the calls
that launched their kernels (one forward kernel; the backward's two, one
per phase), so a run can show it went through the kernels.

By default a CUDA call checks that every id lies inside its table, which
copies the ids' range to the host: two device→host copies a call that
wait for the card.  ``check_ids=False`` leaves the check out, so a call
makes no host sync; a caller passing it has proved its ids in range (the
training engine does so once per run, ``core/mapreduce.py``).  An id out
of range is then a read outside the table.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NORMS = {"l1": 0, "l2": 1}
MAX_DIM = 256                   # eight columns per lane in the backward


def _library() -> ctypes.CDLL:
    lib = build.load("transe_score")
    if not getattr(lib, "_repro_bound", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.transe_score_fwd_launch.argtypes = (
            [p] * 6 + [i64] * 4 + [i32] * 3 + [ctypes.c_float, p])
        lib.transe_score_fwd_launch.restype = i32
        lib.transe_score_bwd_launch.argtypes = (
            [p] * 14 + [i64] * 6 + [i32] * 3 + [p])
        lib.transe_score_bwd_launch.restype = i32
        lib.transe_score_error_string.argtypes = [i32]
        lib.transe_score_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _layout(ent, rel, idx, name, check_ids):
    """``(n, per_worker, ent_worker_stride, rel_worker_stride)`` of the
    kernels' layout; raises on what the kernels do not take, and, with
    ``check_ids``, on an id outside its table."""
    dev = idx.device
    if dev.type != "cuda" or ent.device != dev or rel.device != dev:
        raise ValueError(
            f"{name} takes ent, rel and idx all on the CPU (plain version) "
            f"or all on one CUDA device (kernel); got {ent.device}, "
            f"{rel.device}, {dev}")
    if ent.dtype not in _DTYPES or rel.dtype != ent.dtype:
        raise TypeError(f"{name} kernel takes fp32 or bf16 tables of one "
                        f"dtype; got {ent.dtype} and {rel.dtype}")
    if idx.dtype != torch.int32 or idx.shape[-1:] != (5,):
        raise TypeError(f"{name} takes int32 (..., 5) triplet ids; got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    stacked = ent.dim() == 3
    if ent.dim() not in (2, 3) or rel.dim() != ent.dim() or \
            idx.dim() != ent.dim() or (stacked and not (
                ent.shape[0] == rel.shape[0] == idx.shape[0])):
        raise ValueError(
            f"{name} takes (E, k), (R, k), (B, 5) or (W, E, k), (W, R, k), "
            f"(W, B, 5); got {tuple(ent.shape)}, {tuple(rel.shape)}, "
            f"{tuple(idx.shape)}")
    k = ent.shape[-1]
    if rel.shape[-1] != k or not 1 <= k <= MAX_DIM:
        raise ValueError(f"{name} kernel takes one k in [1, {MAX_DIM}]; "
                         f"got {ent.shape[-1]} and {rel.shape[-1]}")
    strides = []
    for label, t in (("ent", ent), ("rel", rel)):
        rows = t.shape[-2]
        many = stacked and t.shape[0] > 1
        if t.stride(-1) != 1 or (rows > 1 and t.stride(-2) != k) or (
                many and t.stride(0) not in (0, rows * k)):
            raise ValueError(
                f"{name} kernel needs {label} with contiguous rows, and for "
                f"a stacked table a worker stride of 0 or N·k; got strides "
                f"{t.stride()}")
        strides.append(t.stride(0) if many else 0)
    if not idx.is_contiguous():
        raise ValueError(f"{name} kernel needs contiguous idx")
    n = idx.numel() // 5
    if n and check_ids:
        lo, hi = idx.reshape(n, 5).aminmax(dim=0)
        lo, hi = lo.tolist(), hi.tolist()
        sizes = (ent.shape[-2], rel.shape[-2]) + (ent.shape[-2],) * 3
        for col, (a, b, size) in enumerate(zip(lo, hi, sizes)):
            if a < 0 or b >= size:
                raise IndexError(
                    f"{name}: idx[..., {col}] holds ids in [{a}, {b}], "
                    f"outside the table's {size} rows")
    per_worker = idx.shape[-2] if stacked else n
    return n, per_worker, strides[0], strides[1]


def _raise_on(err: int, lib, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.transe_score_error_string(err).decode()} (cudaError {err})")


def transe_score(
    ent: torch.Tensor,         # (E, k) or (W, E, k)
    rel: torch.Tensor,         # (R, k) or (W, R, k)
    idx: torch.Tensor,         # (B, 5) or (W, B, 5) int32 [h, r, t, nh, nt]
    *,
    margin: float = 1.0,
    norm: str = "l1",
    check_ids: bool = True,
):
    """``(loss, d_pos, d_neg)``, each ``idx.shape[:-1]`` fp32: the hinge
    ``max((margin + d_pos) - d_neg, 0)`` and the L1 / L2 distances of
    ``(h + r) - t`` and ``(nh + r) - nt``.  ``check_ids``: see the module
    docstring."""
    if all(t.device.type == "cpu" for t in (ent, rel, idx)):
        return ref.transe_score_ref(ent, rel, idx, margin, norm)
    if norm not in _NORMS:
        raise ValueError(f"norm must be 'l1' or 'l2', got {norm!r}")
    n, per_worker, ent_ws, rel_ws = _layout(ent, rel, idx, "transe_score",
                                            check_ids)
    out = [torch.empty(idx.shape[:-1], dtype=torch.float32,
                       device=idx.device) for _ in range(3)]
    if n == 0:
        return tuple(out)
    lib = _library()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = lib.transe_score_fwd_launch(
            ent.data_ptr(), rel.data_ptr(), idx.data_ptr(),
            *(t.data_ptr() for t in out), n, per_worker, ent_ws, rel_ws,
            ent.shape[-1], _DTYPES[ent.dtype], _NORMS[norm], margin, stream)
    _raise_on(err, lib, "transe_score")
    transe_score.launches += 1
    return tuple(out)


def transe_score_bwd(
    ent: torch.Tensor,
    rel: torch.Tensor,
    idx: torch.Tensor,
    g: torch.Tensor,           # idx.shape[:-1] fp32, upstream gradient of loss
    loss: torch.Tensor,        # the forward's outputs
    d_pos: torch.Tensor,
    d_neg: torch.Tensor,
    *,
    norm: str = "l1",
    check_ids: bool = True,
):
    """Dense ``(d_ent, d_rel)``: the gradients of ``Σ g · loss`` with respect
    to the tables, shaped as the tables (a stacked table's gradient has one
    slice per worker) and contiguous, in the tables' dtype.  Each row sums
    its contributions in a fixed order (``ref.scatter_rows``), so two runs
    give the same bits, and a row no triplet references is ``+0.0``.
    ``check_ids``: see the module docstring."""
    if all(t.device.type == "cpu"
           for t in (ent, rel, idx, g, loss, d_pos, d_neg)):
        return ref.transe_score_bwd_ref(ent, rel, idx, g, loss, d_pos,
                                        d_neg, norm)
    if norm not in _NORMS:
        raise ValueError(f"norm must be 'l1' or 'l2', got {norm!r}")
    n, per_worker, ent_ws, rel_ws = _layout(ent, rel, idx,
                                            "transe_score_bwd", check_ids)
    for label, t in (("g", g), ("loss", loss), ("d_pos", d_pos),
                     ("d_neg", d_neg)):
        if t.device != idx.device or t.dtype != torch.float32 or \
                t.shape != idx.shape[:-1] or not t.is_contiguous():
            raise ValueError(
                f"transe_score_bwd takes a contiguous fp32 {label} of shape "
                f"{tuple(idx.shape[:-1])} on {idx.device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if n == 0:
        return (torch.zeros(ent.shape, dtype=ent.dtype, device=idx.device),
                torch.zeros(rel.shape, dtype=rel.dtype, device=idx.device))
    out_rows = (ent.shape[:-1].numel(), rel.shape[:-1].numel())
    if max(out_rows) >= 2**31 or 4 * n >= 2**31:
        raise ValueError(f"transe_score_bwd kernel takes int32 gradient "
                         f"rows and contribution ids; got {out_rows} rows "
                         f"and {n} triplets")
    # the second launch writes every row, +0.0 where no triplet points
    d_ent = torch.empty(ent.shape, dtype=ent.dtype, device=idx.device)
    d_rel = torch.empty(rel.shape, dtype=rel.dtype, device=idx.device)
    # each triplet's gu, gv: written by the first launch, read by the second
    grads = torch.empty((n, 2, ent.shape[-1]), dtype=torch.float32,
                        device=idx.device)
    ent_rows, rel_rows = ref.scatter_rows(ent, rel, idx)
    ent_rows, ent_perm = torch.sort(ent_rows, stable=True)
    rel_rows, rel_perm = torch.sort(rel_rows, stable=True)
    sorted_ids = [t.to(torch.int32)
                  for t in (ent_rows, ent_perm, rel_rows, rel_perm)]
    lib = _library()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = lib.transe_score_bwd_launch(
            ent.data_ptr(), rel.data_ptr(), idx.data_ptr(), g.data_ptr(),
            loss.data_ptr(), d_pos.data_ptr(), d_neg.data_ptr(),
            grads.data_ptr(), *(t.data_ptr() for t in sorted_ids),
            d_ent.data_ptr(), d_rel.data_ptr(), n, per_worker, ent_ws,
            rel_ws, *out_rows,
            ent.shape[-1], _DTYPES[ent.dtype], _NORMS[norm], stream)
    _raise_on(err, lib, "transe_score_bwd")
    transe_score_bwd.launches += 1
    return d_ent, d_rel


transe_score.launches = 0
transe_score_bwd.launches = 0
