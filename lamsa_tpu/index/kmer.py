"""Sorted k-mer index: on-device replacement for the GEM mapper.

The reference shells out to the external GEM FM-index binary for
approximate seed matching (SURVEY.md section 2 L3 — "the one process
boundary in the program"). We cannot and should not reproduce a binary;
the on-device equivalent (SURVEY.md section 7 step 2) matches seeds by
the pigeonhole principle: a ~50 bp seed with <= e edits contains an
exact piece of length k = seed_len // (e+1); exact pieces are matched
against this index with pure gathers + vectorized binary search, and
false candidates are eliminated by sparse-DP chaining (ops/chain.py)
and banded-DP verification — both on device.

Layout (all flat arrays, device-resident at align time):
  keys:      uint32[U]  sorted unique k-mer codes (2 bits/base, k <= 16)
  starts:    int32[U]   offset of each key's positions in `positions`
  counts:    int32[U]   number of positions (capped at max_hits_per_kmer
                        by evenly-spaced subsampling at build time)
  positions: int32/int64[P] reference start positions, ascending per key

Only the forward strand is indexed; reverse-strand hits come from
looking up the reverse-complemented read (pipeline/seeding.py).
"""

from __future__ import annotations

import math


def auto_kmer(genome_len: int) -> int:
    """Seeding piece length scaled to genome size: ~log4(L) + 2, in
    [13, 16] — keeps expected random hits per k-mer around or below 1.
    Used both for the sorted k-mer index's k and for the FM backend's
    backward-search piece length (the FM index itself is k-agnostic):
    at GRCh38 scale a random 13-mer occurs ~46 times, which floods the
    per-read hit budget with noise; 16-mers restore specificity."""
    return int(min(16, max(13, math.ceil(math.log(max(genome_len, 2), 4))
                           + 2)))

import dataclasses
import json
import os

import numpy as np

_META = "kmer_meta.json"


def kmer_codes(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All k-mer keys of a nt4 code array.

    Returns (keys: uint32[L-k+1], valid: bool[L-k+1]); windows containing
    N (code >= 4) are invalid (key contents undefined there).
    """
    L = len(codes)
    if L < k:
        return np.zeros(0, np.uint32), np.zeros(0, bool)
    n = L - k + 1
    keys = np.zeros(n, np.uint32)
    valid = np.ones(n, bool)
    c = codes.astype(np.uint32)
    bad = codes >= 4
    for t in range(k):
        keys = (keys << np.uint32(2)) | (c[t:t + n] & np.uint32(3))
        valid &= ~bad[t:t + n]
    return keys, valid


@dataclasses.dataclass
class KmerIndex:
    k: int
    keys: np.ndarray        # uint32[U] sorted unique
    starts: np.ndarray      # int32[U]
    counts: np.ndarray      # int32[U]
    positions: np.ndarray   # int64[P]

    @classmethod
    def build(cls, ref_codes: np.ndarray, k: int,
              max_hits_per_kmer: int = 64) -> "KmerIndex":
        if not 1 <= k <= 16:
            raise ValueError(f"k={k} out of range (1..16)")
        keys, valid = kmer_codes(ref_codes, k)
        pos = np.nonzero(valid)[0]
        keys = keys[pos]
        order = np.argsort(keys, kind="stable")   # stable keeps pos ascending
        skeys = keys[order]
        spos = pos[order].astype(np.int64)
        ukeys, ustarts, ucounts = np.unique(skeys, return_index=True,
                                            return_counts=True)
        # cap over-frequent k-mers by evenly-spaced subsampling (the
        # repetitive-seed filter; GEM had an analogous hit cap [P]).
        if (ucounts > max_hits_per_kmer).any():
            keep = np.ones(len(spos), bool)
            for ui in np.nonzero(ucounts > max_hits_per_kmer)[0]:
                s, c = ustarts[ui], ucounts[ui]
                sel = np.linspace(0, c - 1, max_hits_per_kmer).astype(int)
                m = np.zeros(c, bool)
                m[sel] = True
                keep[s:s + c] = m
            spos = spos[keep]
            skeys = skeys[keep]
            ukeys, ustarts, ucounts = np.unique(skeys, return_index=True,
                                                return_counts=True)
        return cls(k=k, keys=ukeys.astype(np.uint32),
                   starts=ustarts.astype(np.int32),
                   counts=ucounts.astype(np.int32),
                   positions=spos)

    # ---------------------------------------------------------- persistence

    def save(self, index_dir: str) -> None:
        os.makedirs(index_dir, exist_ok=True)
        with open(os.path.join(index_dir, _META), "w") as fh:
            json.dump({"format": "lamsa_tpu_kmer_v1", "k": self.k}, fh)
        np.save(os.path.join(index_dir, "kmer_keys.npy"), self.keys)
        np.save(os.path.join(index_dir, "kmer_starts.npy"), self.starts)
        np.save(os.path.join(index_dir, "kmer_counts.npy"), self.counts)
        np.save(os.path.join(index_dir, "kmer_positions.npy"), self.positions)

    @classmethod
    def load(cls, index_dir: str) -> "KmerIndex":
        with open(os.path.join(index_dir, _META)) as fh:
            meta = json.load(fh)
        if meta.get("format") != "lamsa_tpu_kmer_v1":
            raise ValueError(f"{index_dir}: not a lamsa_tpu k-mer index")
        return cls(
            k=meta["k"],
            keys=np.load(os.path.join(index_dir, "kmer_keys.npy")),
            starts=np.load(os.path.join(index_dir, "kmer_starts.npy")),
            counts=np.load(os.path.join(index_dir, "kmer_counts.npy")),
            positions=np.load(os.path.join(index_dir, "kmer_positions.npy")),
        )

    def lookup_host(self, key: int) -> np.ndarray:
        """Host-side single-key lookup (tests/debugging)."""
        i = np.searchsorted(self.keys, np.uint32(key))
        if i < len(self.keys) and self.keys[i] == key:
            s, c = self.starts[i], self.counts[i]
            return self.positions[s:s + c]
        return np.zeros(0, np.int64)
