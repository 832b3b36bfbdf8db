"""Real-dataset ingestion: FB15k / WN18 / NELL-style TSV triples, streamed
(port of ``repro.data.datasets``, numpy only, the same ids and caches).

TSV format
----------
One triple per line, UTF-8::

    head<TAB>relation<TAB>tail

No header, no quoting; lines with any other tab-separated field count are
skipped (matching ``data/kg.load_tsv_dir``, the in-RAM reference loader).
Two layouts are accepted:

* a **dataset directory** holding ``train.txt`` / ``valid.txt`` /
  ``test.txt`` — the layout the FB15k, WN18, and NELL-995 releases ship
  in; missing split files become empty splits;
* a **single TSV file**, split deterministically into train/valid/test by
  a seeded permutation (``valid_frac`` / ``test_frac``, ``seed``).

Entities and relations are interned into dense int32 ids in first-seen
order — per line head, then relation, then tail, streaming train → valid
→ test — which is *identical* id assignment to ``load_tsv_dir``, so for a
dataset directory the two loaders produce the same :class:`KG` triple for
triple (pinned by tests/test_torch_online.py).  Unlike
``load_tsv_dir``, nothing here materializes per-line Python tuples for the
whole corpus:
lines are encoded into bounded chunks, so peak memory is the vocabulary
plus the final int32 arrays — million-triple files stream through.

Fingerprint compatibility
-------------------------
The returned :class:`~repro_torch.data.kg.KG` holds contiguous ``(N, 3)`` int32
splits — exactly the byte layout ``KG.fingerprint()`` hashes (sha256 of
the contiguous int32 rows per split) — so a graph loaded from the same
files fingerprints identically whether it was streamed, cached, or
memory-mapped, and checkpoint / ``KnowledgeBase`` manifest validation
works across loads and processes.

Caching / memory-mapping
------------------------
``cache_dir=`` persists the encoded splits as raw ``.npy`` files plus a
``vocab.json`` / ``meta.json`` pair; later loads skip parsing entirely
and (with ``mmap=True``, the default) memory-map the arrays, so a
million-triple graph opens in milliseconds and its triples page in on
demand.

Cache-validation contract: ``meta.json`` records each source file's size
and ``mtime_ns`` at write time (``"sources"``), and a cached load is
served only while every recorded file still exists with the same
fingerprint and no *new* split file has appeared in a dataset directory
— any mismatch (including a pre-contract cache with no ``"sources"``
key) silently re-ingests and rewrites the cache, so editing a TSV never
leaves a stale cache in play.  The one deliberate exception: when every
source file is gone (the ship-the-cache, drop-the-raw workflow), a
complete cache is served as-is — there is nothing to re-ingest from, and
re-parsing an empty directory would destroy the cache.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.data.kg import KG

SPLIT_FILES = ("train.txt", "valid.txt", "test.txt")
_CHUNK = 1 << 16


def iter_triples(path: str) -> Iterator[Tuple[str, str, str]]:
    """Stream ``(head, relation, tail)`` string triples from one TSV file,
    skipping malformed lines."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 3:
                yield parts[0], parts[1], parts[2]


def _intern(vocab: Dict[str, int], key: str) -> int:
    ids = vocab.get(key)
    if ids is None:
        ids = vocab[key] = len(vocab)
    return ids


def _encode_stream(
    path: str, ent2id: Dict[str, int], rel2id: Dict[str, int]
) -> np.ndarray:
    """Encode one TSV file into a contiguous (N, 3) int32 array, interning
    names in first-seen (head, relation, tail) line order, in bounded
    chunks."""
    chunks, buf = [], []
    for h, r, t in iter_triples(path):
        buf.append((_intern(ent2id, h), _intern(rel2id, r),
                    _intern(ent2id, t)))
        if len(buf) >= _CHUNK:
            chunks.append(np.asarray(buf, np.int32))
            buf = []
    if buf:
        chunks.append(np.asarray(buf, np.int32))
    if not chunks:
        return np.zeros((0, 3), np.int32)
    return chunks[0] if len(chunks) == 1 else np.concatenate(chunks, axis=0)


def _split_single(
    triples: np.ndarray, valid_frac: float, test_frac: float, seed: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic seeded split of one encoded file: a permutation drawn
    from ``default_rng(seed)`` deals out test, then valid, then train."""
    if not 0.0 <= valid_frac + test_frac < 1.0:
        raise ValueError(
            f"valid_frac={valid_frac} + test_frac={test_frac} must leave "
            "room for a train split")
    n = len(triples)
    perm = np.random.default_rng(seed).permutation(n)
    n_test = int(n * test_frac)
    n_valid = int(n * valid_frac)
    test = np.ascontiguousarray(triples[perm[:n_test]])
    valid = np.ascontiguousarray(triples[perm[n_test:n_test + n_valid]])
    train = np.ascontiguousarray(triples[perm[n_test + n_valid:]])
    return train, valid, test


def _load_raw(
    path: str, valid_frac: float, test_frac: float, seed: int
) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray],
           Dict[str, int], Dict[str, int]]:
    ent2id: Dict[str, int] = {}
    rel2id: Dict[str, int] = {}
    if os.path.isdir(path):
        splits = tuple(
            _encode_stream(os.path.join(path, fname), ent2id, rel2id)
            if os.path.exists(os.path.join(path, fname))
            else np.zeros((0, 3), np.int32)
            for fname in SPLIT_FILES
        )
    else:
        allt = _encode_stream(path, ent2id, rel2id)
        splits = _split_single(allt, valid_frac, test_frac, seed)
    return splits, ent2id, rel2id


def _cache_paths(cache_dir: str) -> dict:
    return {
        "train": os.path.join(cache_dir, "train.npy"),
        "valid": os.path.join(cache_dir, "valid.npy"),
        "test": os.path.join(cache_dir, "test.npy"),
        "vocab": os.path.join(cache_dir, "vocab.json"),
        "meta": os.path.join(cache_dir, "meta.json"),
    }


def _source_files(path: str) -> dict:
    """Fingerprint (size + mtime_ns per file) of the TSV sources a cache
    for ``path`` is built from — what ``meta.json`` records at write time
    and :func:`_cache_valid` compares on later loads.  Files that vanished
    are simply omitted (the comparison treats that as a change)."""
    if os.path.isdir(path):
        files = {name: os.path.join(path, name) for name in SPLIT_FILES
                 if os.path.exists(os.path.join(path, name))}
    else:
        files = {os.path.basename(path): path}
    out = {}
    for name, p in files.items():
        try:
            st = os.stat(p)
        except OSError:
            continue
        out[name] = {"size": st.st_size, "mtime_ns": st.st_mtime_ns}
    return out


def _write_cache(cache_dir: str, splits, ent2id, rel2id, sources) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    paths = _cache_paths(cache_dir)
    for name, arr in zip(("train", "valid", "test"), splits):
        tmp = paths[name] + ".tmp.npy"   # .npy suffix: np.save won't append
        np.save(tmp, np.ascontiguousarray(arr, np.int32))
        os.replace(tmp, paths[name])
    with open(paths["vocab"] + ".tmp", "w", encoding="utf-8") as f:
        json.dump({"entities": list(ent2id), "relations": list(rel2id)}, f)
    os.replace(paths["vocab"] + ".tmp", paths["vocab"])
    with open(paths["meta"] + ".tmp", "w", encoding="utf-8") as f:
        json.dump({"n_entities": len(ent2id), "n_relations": len(rel2id),
                   "sources": sources}, f)
    os.replace(paths["meta"] + ".tmp", paths["meta"])


def _cache_complete(cache_dir: str) -> bool:
    paths = _cache_paths(cache_dir)
    return all(os.path.exists(paths[k])
               for k in ("train", "valid", "test", "meta"))


def _cache_valid(cache_dir: str, path: str) -> bool:
    """Complete AND fresh (the module-docstring cache-validation
    contract): every cache file exists and ``meta.json``'s recorded source
    fingerprints match the TSVs on disk right now.  A missing ``sources``
    record (a pre-contract cache) is stale — one re-ingest upgrades it.
    Sources that vanished *entirely* leave nothing to re-ingest from, so a
    complete cache is then served as-is."""
    if not _cache_complete(cache_dir):
        return False
    with open(_cache_paths(cache_dir)["meta"], encoding="utf-8") as f:
        meta = json.load(f)
    recorded = meta.get("sources")
    if recorded is None:
        return False
    current = _source_files(path)
    if not current:
        return True
    return recorded == current


def _load_cache(cache_dir: str, mmap: bool) -> KG:
    paths = _cache_paths(cache_dir)
    with open(paths["meta"], encoding="utf-8") as f:
        meta = json.load(f)
    mode = "r" if mmap else None
    train, valid, test = (
        np.load(paths[name], mmap_mode=mode)
        for name in ("train", "valid", "test"))
    return KG(int(meta["n_entities"]), int(meta["n_relations"]),
              train, valid, test)


def load_vocab(cache_dir: str) -> Tuple[Dict[str, int], Dict[str, int]]:
    """The (ent2id, rel2id) maps a cached dataset was encoded with."""
    with open(_cache_paths(cache_dir)["vocab"], encoding="utf-8") as f:
        vocab = json.load(f)
    return (
        {name: i for i, name in enumerate(vocab["entities"])},
        {name: i for i, name in enumerate(vocab["relations"])},
    )


def extend_vocab(
    triples,
    ent2id: Dict[str, int],
    rel2id: Dict[str, int],
) -> np.ndarray:
    """Encode ``(head, relation, tail)`` string triples against existing
    vocabulary maps, interning unseen names **in place** — per triple head,
    then relation, then tail, in input order — exactly the first-seen id
    assignment :func:`load_dataset` / ``kg.load_tsv_dir`` use while
    streaming.  The online tier leans on this identity: a graph grown
    incrementally by ``kb.update()`` assigns the same ids (hence the same
    canonical fingerprints) as re-ingesting the concatenated TSV from
    scratch (pinned by tests/test_torch_online.py).  Returns the encoded
    ``(N, 3)`` int32 array."""
    rows = []
    for h, r, t in triples:
        rows.append((_intern(ent2id, str(h)), _intern(rel2id, str(r)),
                     _intern(ent2id, str(t))))
    if not rows:
        return np.zeros((0, 3), np.int32)
    return np.asarray(rows, np.int32)


def load_dataset(
    path: str,
    *,
    valid_frac: float = 0.05,
    test_frac: float = 0.05,
    seed: int = 0,
    cache_dir: Optional[str] = None,
    mmap: bool = True,
) -> KG:
    """Load a TSV knowledge graph (see the module docstring for the format).

    ``path`` is a dataset directory (``train.txt``/``valid.txt``/
    ``test.txt``) or a single TSV file (deterministically seeded split by
    ``valid_frac``/``test_frac``).  ``cache_dir`` persists the encoded
    int32 splits + vocabulary on first load and reuses them (memory-mapped
    when ``mmap``) while the source files are unchanged; an edited source
    re-ingests and rewrites the cache (see the cache-validation contract
    in the module docstring)."""
    if cache_dir is not None and _cache_valid(cache_dir, path):
        return _load_cache(cache_dir, mmap)
    # fingerprint BEFORE parsing: a source modified mid-parse then makes
    # the next load stale (conservative) instead of silently current
    sources = _source_files(path) if cache_dir is not None else None
    splits, ent2id, rel2id = _load_raw(path, valid_frac, test_frac, seed)
    if cache_dir is not None:
        _write_cache(cache_dir, splits, ent2id, rel2id, sources)
        return _load_cache(cache_dir, mmap)
    return KG(len(ent2id), len(rel2id), *splits)


def write_tsv(path: str, triples: np.ndarray,
              ent_fmt: str = "e{}", rel_fmt: str = "r{}") -> None:
    """Write an encoded ``(N, 3)`` int id array as a loader-compatible TSV
    (ids rendered through ``ent_fmt``/``rel_fmt``) — the inverse direction
    for round-trip tests and synthetic-at-scale benchmarks."""
    with open(path, "w", encoding="utf-8") as f:
        for h, r, t in np.asarray(triples).tolist():
            f.write(f"{ent_fmt.format(h)}\t{rel_fmt.format(r)}"
                    f"\t{ent_fmt.format(t)}\n")
