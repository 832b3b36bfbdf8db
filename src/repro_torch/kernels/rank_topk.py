"""Streaming entity-inference ranking: the wrapper of the CUDA kernel
``csrc/rank_topk.cu`` (port of ``repro.kernels.rank_topk``).

The paper's evaluation scores EVERY entity as a candidate replacement for
each test triplet, an O(B·E·k) sweep.  The kernel streams table tiles
through shared memory and keeps only a per-query count of entities
strictly closer than the gold, never a (B, E) distance matrix.

On CPU tensors the wrapper computes the plain version
(``ref.rank_counts_ref``); on CUDA tensors it launches the kernel or
raises — there is no fallback between the two.  ``rank_counts.launches``
counts kernel launches, so a run can show it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NORMS = {"l1": 0, "l2": 1}
MAX_QUERIES = 65535 * 64        # grid rows x query tile
MAX_DIM = 256                   # (64 + 128) x 257 fp32 rows <= 227 KB smem


def _library() -> ctypes.CDLL:
    lib = build.load("rank_topk")
    if not getattr(lib, "_repro_bound", False):
        fn = lib.rank_counts_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rank_counts_error_string.argtypes = [ctypes.c_int]
        lib.rank_counts_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check(queries, table, gold_d, norm):
    dev = queries.device
    if dev.type != "cuda" or table.device != dev or gold_d.device != dev:
        raise ValueError(
            "rank_counts takes queries, table and gold_d all on the CPU "
            "(plain version) or all on one CUDA device (kernel); got "
            f"{queries.device}, {table.device}, {gold_d.device}")
    if queries.dtype not in _DTYPES or table.dtype != queries.dtype:
        raise TypeError(
            "rank_counts kernel takes fp32 or bf16 queries and table of one "
            f"dtype; got {queries.dtype} and {table.dtype}")
    if gold_d.dtype != torch.float32:
        raise TypeError(f"gold_d must be float32, got {gold_d.dtype}")
    if queries.dim() != 2 or table.dim() != 2 or gold_d.dim() != 1:
        raise ValueError("rank_counts takes (B, k) queries, (E, k) table "
                         "and (B,) gold_d")
    B, k = queries.shape
    if table.shape[1] != k or gold_d.shape[0] != B:
        raise ValueError(
            f"shape mismatch: queries {tuple(queries.shape)}, table "
            f"{tuple(table.shape)}, gold_d {tuple(gold_d.shape)}")
    if not 1 <= k <= MAX_DIM or B > MAX_QUERIES:
        raise ValueError(
            f"rank_counts kernel takes 1 <= k <= {MAX_DIM} and at most "
            f"{MAX_QUERIES} queries; got k={k}, B={B}")
    for name, t in (("queries", queries), ("table", table),
                    ("gold_d", gold_d)):
        if not t.is_contiguous():
            raise ValueError(f"rank_counts kernel needs a contiguous {name}")
    if norm not in _NORMS:
        raise ValueError(f"norm must be 'l1' or 'l2', got {norm!r}")


def rank_counts(
    queries: torch.Tensor,     # (B, k)
    table: torch.Tensor,       # (E, k)
    gold_d: torch.Tensor,      # (B,) float32
    *,
    norm: str = "l1",
) -> torch.Tensor:
    """Count of table rows strictly closer than the gold, per query:
    ``(B,)`` int32, rank = 1 + count.  L1 is ``Σ|q - e|``, L2 the expanded
    ``sqrt(max(‖q‖² - 2q·e + ‖e‖², 0) + 1e-12)``; fp32 or bf16 inputs,
    fp32 math."""
    if all(t.device.type == "cpu" for t in (queries, table, gold_d)):
        return ref.rank_counts_ref(queries, table, gold_d, norm)
    _check(queries, table, gold_d, norm)
    B, k = queries.shape
    E = table.shape[0]
    counts = torch.zeros(B, dtype=torch.int32, device=queries.device)
    lib = _library()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = lib.rank_counts_launch(
            queries.data_ptr(), table.data_ptr(), gold_d.data_ptr(),
            counts.data_ptr(), B, E, k, _DTYPES[queries.dtype],
            _NORMS[norm], stream)
    if err != 0:
        raise RuntimeError(
            "rank_counts kernel launch failed: "
            f"{lib.rank_counts_error_string(err).decode()} (cudaError {err})")
    rank_counts.launches += 1
    return counts


rank_counts.launches = 0
