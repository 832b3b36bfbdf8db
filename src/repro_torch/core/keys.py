"""Counter-based random draws on any device, for the device pipeline.

The reference's device pipeline draws from ``jax.random`` keys derived by
``fold_in`` from (seed, stream, epoch, worker) (``repro.core.mapreduce``'s
``_device_keys``), so every draw is a pure function of where it sits in the
run, and how epochs are grouped into blocks cannot change a bit.  The port
keeps that contract with a keyed integer hash instead of a generator:

  * a *key* is a 32-bit value, held as a Python int or as an int64 tensor;
  * :func:`fold_in` derives a key from a key and an integer (an epoch, a
    worker, a round, a stream tag), on the host for Python ints and on the
    device, elementwise, for tensors;
  * :func:`bits` gives 32 random bits per counter ``0 .. n-1`` of a key;
    :func:`uniform`, :func:`randint` and :func:`permutation` are built
    from them.

Everything is integer arithmetic on int64 tensors whose values stay in
``[0, 2**32)``: xor, shifts, and products of a 32-bit value by a constant
below ``2**31``, so no product reaches ``2**63`` and nothing depends on
how a device wraps on overflow.  Floats are 24 bits times ``2**-24``,
exact.  So the CPU and the card give the same bits, and a draw needs no
generator state and no host round trip.

For a fixed key, ``bits`` is a bijection of the 32-bit counters (each
step of :func:`_mix` is invertible), so a permutation drawn as the stable
``argsort`` of ``bits`` over ``n <= 2**32`` counters has no ties.
"""
from __future__ import annotations

from typing import Union

import torch

Key = Union[int, torch.Tensor]

M32 = 0xFFFFFFFF
# fold_in tags of the device pipeline's streams: the reference's values
# (repro.core.mapreduce), copied
DEVICE_STREAM_TAG = 0xD417A
REPARTITION_TAG = 0x5917
STALENESS_TAG = 0x57A1E
# sub-streams of one key
_DATA, _NEGATIVES, _MERGE = 0, 1, 2
_KEY_SALT = 0x5BD1E995


def _mix(x: Key) -> Key:
    """A bijection of ``[0, 2**32)``: xor-shifts and odd multipliers below
    ``2**31`` (products below ``2**63``), on ints and int64 tensors."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & M32
    return x ^ (x >> 16)


def bits(key: Key, counters: Key) -> Key:
    """32 random bits for each counter (``[0, 2**32)``), a pure function of
    ``(key, counter)``; a tensor key broadcasts against the counters."""
    return _mix(_mix(counters ^ key) ^ _mix(key ^ _KEY_SALT))


def fold_in(key: Key, data: Key) -> Key:
    """The key derived from ``key`` and a non-negative integer ``data``
    (elementwise for tensors)."""
    return bits(key, data & M32)


def seed_key(seed: int) -> int:
    """The root key of an integer seed (all of its low 64 bits count)."""
    return fold_in(fold_in(0, seed & M32), (seed >> 32) & M32)


def _root(seed: int) -> int:
    return fold_in(seed_key(seed), DEVICE_STREAM_TAG)


def device_keys(seed: int) -> tuple:
    """``(k_data, k_neg, k_merge, k_part)``: the device pipeline's per-
    purpose base keys.  Every per-epoch key is ``fold_in(base, epoch)``
    (per worker, ``fold_in`` of that with the worker), as in the
    reference's ``_device_keys``."""
    root = _root(seed)
    return (fold_in(root, _DATA), fold_in(root, _NEGATIVES),
            fold_in(root, _MERGE), fold_in(root, REPARTITION_TAG))


def stale_key(seed: int) -> int:
    """``k_stale``, the fifth key of the reference's ``_device_keys``: the
    bounded-staleness refresh phases' stream, folded off the same root
    with its own tag (:data:`STALENESS_TAG`), so the four keys of
    :func:`device_keys` keep their bits."""
    return fold_in(_root(seed), STALENESS_TAG)


def stale_offsets(k_stale: int, n_workers: int, staleness: int,
                  device=None) -> torch.Tensor:
    """The bounded-staleness refresh phases ``o_w`` in ``[0, staleness]``,
    ``(n_workers,)`` int64: worker ``w``'s is one :func:`randint` draw of
    ``fold_in(k_stale, w)``, a pure function of (seed, w), as the
    reference's ``_stale_offsets`` draws them."""
    w = torch.arange(n_workers, dtype=torch.int64, device=device)
    return randint(fold_in(k_stale, w), 1, 0, staleness + 1, device)[:, 0]


def _counters(key: Key, n: int, device) -> tuple:
    """``(key, counters)`` shaped to broadcast to ``key.shape + (n,)``."""
    c = torch.arange(n, dtype=torch.int64, device=device)
    if isinstance(key, torch.Tensor):
        key = key.to(device=device, dtype=torch.int64)[..., None]
    return key, c


def random_bits(key: Key, n: int, device=None) -> torch.Tensor:
    """``bits(key, 0 .. n-1)`` as an int64 tensor ``key.shape + (n,)``."""
    key, c = _counters(key, n, device)
    return bits(key, c)


def uniform(key: Key, n: int, device=None) -> torch.Tensor:
    """``n`` float32 draws in ``[0, 1)`` per key, multiples of ``2**-24``."""
    return (random_bits(key, n, device) >> 8).to(torch.float32) * 2.0**-24


def randint(key: Key, n: int, low: int, high: int,
            device=None) -> torch.Tensor:
    """``n`` int64 draws in ``[low, high)`` per key (multiply-shift of the
    32 bits; ``high - low <= 2**31``)."""
    span = high - low
    if not 0 < span <= 2**31:
        raise ValueError(f"randint needs 0 < high - low <= 2**31; got "
                         f"[{low}, {high})")
    return low + ((random_bits(key, n, device) * span) >> 32)


def permutation(key: Key, n: int, device=None) -> torch.Tensor:
    """A permutation of ``0 .. n-1`` per key (int64 ``key.shape + (n,)``):
    the stable argsort of the counters' bits, which are distinct for
    ``n <= 2**32``."""
    return torch.argsort(random_bits(key, n, device), dim=-1, stable=True)
