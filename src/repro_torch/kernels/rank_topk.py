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

Under L2 the kernel takes the contraction ``q·e`` on the tensor cores and
re-checks in order, as the plain version sums, every pair whose decision
the tensor cores' error could change (:func:`l2_screen_margin`), so its
counts stay those of the plain version exactly.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NORMS = {"l1": 0, "l2": 1}
MAX_QUERIES = 65535 * 64        # queries a call takes
MAX_DIM = 256                   # 6 chunks of 50 fp32 columns fit 227 KB smem
# Kernel attributes of rank_counts_info, in its order.
INFO_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
             "blocks_per_sm", "threads", "local_bytes", "tile_queries")
# The CUDA kernels of one call, by norm: L2 runs a per-row pre-pass first.
KERNELS = {"l1": ("rank_counts_l1_kernel",),
           "l2": ("rank_counts_norms_kernel", "rank_counts_l2_kernel")}
# The L2 screen's safety factor over its error bound (see l2_screen_margin).
SCREEN_FACTOR = 16


def l2_screen_margin(qq: torch.Tensor, ee: torch.Tensor, k: int):
    """``δ`` with ``|qe_tc - qe_plain| <= δ`` for one (query, row) pair:
    ``SCREEN_FACTOR · k · 2⁻²² · (1 + 2⁻¹⁰) · (√qq + 2⁻⁵⁰) · (√ee + 2⁻⁵⁰)``
    (float64, broadcasting), ``qq`` and ``ee`` the in-order fp32 sums of
    squares of the two rows.

    ``qe_plain`` is the plain version's in-order fp32 sum of ``k`` rounded
    products, ``qe_tc`` the tensor cores' (bf16 products are exact; fp32
    goes through 3xTF32, ``hi = tf32(x)``, ``lo = tf32(x - hi)``,
    ``hi·hi + hi·lo + lo·hi``).  Each error below is a multiple of
    ``Σ|q_j e_j|``, at most ``‖q‖·‖e‖`` by Cauchy–Schwarz:

    * the in-order sum: ``γ_k = k·u / (1 - k·u)``, ``u = 2⁻²⁴``;
    * the TF32 split: ``|x - hi - lo| <= 2⁻²² |x|`` and the dropped
      ``lo·lo <= 2⁻²² |q_j e_j|``, about ``3 · 2⁻²²`` in all;
    * the tensor cores' accumulation, which is not IEEE (truncating adds,
      a few ``2⁻²³`` per ``mma`` of 8 or 16 products, three passes);
    * ``√qq``, ``√ee`` from fp32 sums: relative ``k · 2⁻²⁵``, inside the
      ``1 + 2⁻¹⁰``.

    The ``2⁻⁵⁰`` terms cover products that underflow.  Together these come
    to about ``(0.7 k + 7) · 2⁻²²`` of ``‖q‖·‖e‖``, under ``16 · k · 2⁻²²``
    for every ``k >= 1``.  The accumulation term is an estimate (the
    adders' rounding is not published), so the factor is generous: a
    wider band costs only re-checks, never a wrong count, and the card
    tests hold the kernel against the plain version at near-ties.
    ``csrc/rank_topk.cu`` uses the same bound, rounded up."""
    qq = torch.as_tensor(qq, dtype=torch.float64)
    ee = torch.as_tensor(ee, dtype=torch.float64)
    return (SCREEN_FACTOR * k * 2.0 ** -22 * (1 + 2.0 ** -10)
            * (qq.sqrt() + 2.0 ** -50) * (ee.sqrt() + 2.0 ** -50))


def _library() -> ctypes.CDLL:
    lib = build.load("rank_topk")
    if not getattr(lib, "_repro_bound", False):
        fn = lib.rank_counts_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        lib.rank_counts_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.rank_counts_scratch_floats.restype = ctypes.c_longlong
        lib.rank_counts_info.argtypes = [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.rank_counts_info.restype = ctypes.c_int
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
    recheck_counter: torch.Tensor | None = None,
) -> torch.Tensor:
    """Count of table rows strictly closer than the gold, per query:
    ``(B,)`` int32, rank = 1 + count.  L1 is ``Σ|q - e|``, L2 the expanded
    ``sqrt(max(‖q‖² - 2q·e + ‖e‖², 0) + 1e-12)``; fp32 or bf16 inputs,
    fp32 math.

    ``recheck_counter``: an optional ``(1,)`` int64 tensor on the queries'
    CUDA device, to which the L2 kernel adds the pairs it re-checked in
    order (none under L1).  The main path passes none."""
    if all(t.device.type == "cpu" for t in (queries, table, gold_d)):
        return ref.rank_counts_ref(queries, table, gold_d, norm)
    _check(queries, table, gold_d, norm)
    if recheck_counter is not None and (
            recheck_counter.device != queries.device
            or recheck_counter.dtype != torch.int64
            or recheck_counter.numel() != 1):
        raise ValueError("recheck_counter must be a (1,) int64 tensor on "
                         "the queries' device")
    B, k = queries.shape
    E = table.shape[0]
    counts = torch.zeros(B, dtype=torch.int32, device=queries.device)
    lib = _library()
    scratch = None
    if norm == "l2":            # the pre-pass's per-row sums
        scratch = torch.empty(
            lib.rank_counts_scratch_floats(B, E, _NORMS[norm]),
            dtype=torch.float32, device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = lib.rank_counts_launch(
            queries.data_ptr(), table.data_ptr(), gold_d.data_ptr(),
            counts.data_ptr(), B, E, k, _DTYPES[queries.dtype],
            _NORMS[norm], None if recheck_counter is None
            else recheck_counter.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            "rank_counts kernel launch failed: "
            f"{lib.rank_counts_error_string(err).decode()} (cudaError {err})")
    rank_counts.launches += 1
    return counts


rank_counts.launches = 0


def kernel_info(dtype: torch.dtype, norm: str, k: int, B: int,
                E: int) -> dict:
    """The main kernel's attributes for one (dtype, norm) at width ``k``
    over ``B`` queries and ``E`` rows on the current CUDA device: registers
    a thread, static and dynamic shared bytes a block, blocks an SM holds,
    threads a block, local (spill) bytes a thread, queries a tile
    (``INFO_KEYS``)."""
    lib = _library()
    out = (ctypes.c_int * len(INFO_KEYS))()
    err = lib.rank_counts_info(_DTYPES[dtype], _NORMS[norm], k, B, E, out)
    if err != 0:
        raise RuntimeError(
            "rank_counts_info failed: "
            f"{lib.rank_counts_error_string(err).decode()} (cudaError {err})")
    return dict(zip(INFO_KEYS, out))
