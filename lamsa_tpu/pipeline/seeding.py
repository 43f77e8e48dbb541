"""On-device seeding: batched k-mer extraction, index lookup, hit packing.

On-device replacement for the reference's seed-FASTQ -> fork/exec
gem-mapper -> parse ``.map`` pipeline stage (SURVEY.md sections 3.2/2b
"Seeding glue"): instead of a subprocess boundary, seeding is one jitted
function of (read batch, index arrays) -> per-read hit arrays, all
gathers and a vectorized binary search — no host round-trip.

Both strands are sampled from the same physical read windows: the
reverse-complement k-mer of the window at forward position p represents
the reverse-complemented read's k-mer at rc-coordinate (read_len - p - k).
Reverse-strand chains therefore live in rc-read coordinates, which is
exactly the orientation SAM reverse-strand records use.

Hit packing: hits are sorted per read by (strand, qpos, rpos) with a
two-key lexicographic ``lax.sort`` — the order the chain kernel
(ops/chain.py) requires — and truncated to a static max_hits_per_read.
All device integers are 32-bit (JAX runs without x64); reference
positions are uint32 bit-patterns carried in int32 arrays, so genomes up
to 4 Gb (GRCh38 = 3.1 Gb) are addressable. Hosts must reinterpret with
``.view(np.uint32)`` before widening.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_QPOS_BITS = 19                       # reads up to 512 kb
INVALID_K1 = jnp.int32(1 << 24)       # > any strand<<QPOS_BITS | qpos


def extract_windows(read_codes, read_len, qpos_grid, k):
    """Window gather: (B, S, k) nt4 windows + (B, S) validity."""
    win_idx = qpos_grid[:, None] + jnp.arange(k)[None, :]        # (S, k)
    win = read_codes[:, win_idx]                                  # (B, S, k)
    win_ok = jnp.all(win < 4, axis=2) & (
        (qpos_grid[None, :] + k) <= read_len[:, None])            # (B, S)
    return win, win_ok


def window_keys(win, k):
    """Packed 2-bit k-mer keys for both strands of (B, S, k) windows."""
    w32 = win.astype(jnp.uint32) & jnp.uint32(3)
    shifts_f = (2 * (k - 1 - jnp.arange(k))).astype(jnp.uint32)
    shifts_r = (2 * jnp.arange(k)).astype(jnp.uint32)
    key_f = jnp.sum(w32 << shifts_f[None, None, :], axis=2,
                    dtype=jnp.uint32)
    key_r = jnp.sum((w32 ^ jnp.uint32(3)) << shifts_r[None, None, :], axis=2,
                    dtype=jnp.uint32)
    return key_f, key_r


def seed_rotation(qpos_grid):
    """Per-window quasi-random rotation used to place each seed's
    C-candidate sampling window inside an over-full occurrence list
    (candidate_rotation below). int32 (S,) from the static grid —
    deterministic, engine-independent."""
    return (qpos_grid.astype(jnp.uint32)
            * jnp.uint32(2654435761)) >> jnp.uint32(8)


def candidate_rotation(rot, count, C):
    """Offset into a key's occurrence list for a seed keeping C of
    `count` candidates. Occurrence lists are position-sorted, so
    always keeping the FIRST C biases every seed toward the lowest-
    coordinate copies of a >C-occurrence repeat family — the read's
    true (higher-coordinate) copy then never seeds at all and a wrong
    copy chains confidently (measured: 5% wrong at MAPQ >= 30 on the
    repeat-family world, tools/repeat_bench.py). Rotating each seed's
    window by a per-qpos hash samples all copies across a read's
    seeds. Identity (0) whenever count <= C, so unique-genome hit
    sets — and every existing world below ~17 copies — are unchanged
    bit-for-bit."""
    maxoff = jnp.maximum(count - C + 1, 1).astype(jnp.uint32)
    return jnp.where(count > C,
                     (rot % maxoff).astype(jnp.int32), 0)


def table_lookup(keys, idx_keys, idx_starts, idx_counts, idx_positions, C,
                 rot=None):
    """Sorted-table candidate lookup: (…,) keys -> (…, C) positions + ok.
    Keys absent from idx_keys (including any sentinel padding with
    count 0) yield ok=False lanes. rot: optional per-window rotation
    (seed_rotation) for >C-occurrence keys."""
    i = jnp.searchsorted(idx_keys, keys)
    i_c = jnp.minimum(i, idx_keys.shape[0] - 1)
    found = (i < idx_keys.shape[0]) & (idx_keys[i_c] == keys)
    start = idx_starts[i_c]
    count = idx_counts[i_c]
    o0 = jnp.zeros_like(count) if rot is None else \
        candidate_rotation(rot[None, :], count, C)
    offs = jnp.arange(C)[None, None, :]
    pidx = jnp.minimum(start[..., None] + o0[..., None] + offs,
                       idx_positions.shape[0] - 1)
    pos = idx_positions[pidx]                                     # (…, C)
    ok = found[..., None] & (o0[..., None] + offs < count[..., None])
    return pos, ok


def pack_positions16(positions):
    """Host-side: reshape the flat position table into 16-wide records
    for table_lookup_direct's record gather (padded; pipeline/aln.py
    uploads this for the device path's direct-address lookup)."""
    import numpy as np
    p = np.asarray(positions)
    pad = (-len(p)) % 16
    return np.concatenate(
        [p, np.zeros(pad + 16, p.dtype)]).reshape(-1, 16)


def table_lookup_direct(keys, dense_starts, dense_counts, pos16, C,
                        rot=None):
    """Direct-address variant of table_lookup: dense 4^k tables replace
    the binary search with a single gather (k <= 13 keeps the tables at
    2 x 256 MB; pipeline/aln.py builds them on the device path).

    The C candidate positions of a key are CONTIGUOUS in the position
    table, so they are fetched as TWO 16-wide row records (pos16 =
    pack_positions16 layout) and realigned with a 4-stage log-shift —
    2 gathers per window instead of C elementwise gathers.
    Requires C <= 16 (start & 15 + C <= 32). rot shifts the sampling
    window for >C-occurrence keys (candidate_rotation) — the records
    stay contiguous, so the gather cost is unchanged."""
    assert C <= 16
    start = dense_starts[keys]
    count = dense_counts[keys]
    if rot is not None:
        start = start + candidate_rotation(rot[None, :], count, C)
        count = count - (start - dense_starts[keys])
    count = jnp.minimum(count, C)
    rows = (start >> 4)[..., None] + jnp.arange(2, dtype=jnp.int32)
    rec = pos16[jnp.clip(rows, 0, pos16.shape[0] - 1)]
    flat = rec.reshape(*start.shape, 32)
    sh = (start & 15)[..., None]
    for kbit in range(4):
        flat = jnp.where((sh & (1 << kbit)) != 0,
                         jnp.roll(flat, -(1 << kbit), axis=-1), flat)
    pos = flat[..., :C]
    offs = jnp.arange(C)[None, None, :]
    ok = offs < count[..., None]                  # absent keys: count 0
    return pos, ok


def pack_hits(qpos_grid, read_len, pos_f, ok_f, pos_r, ok_r, win_ok, *,
              k, max_hits):
    """Candidate (pos, ok) pairs for both strands -> the sorted,
    truncated per-read hit arrays (the seed_hits output contract).

    Sort is single-key (strand|qpos) and STABLE: each key1 value is one
    seed window's candidate slots, which arrive rpos-ascending from the
    position table, so the (strand, qpos, rpos) output order is
    preserved without paying for a second sort key. (The FM path sorts
    two-key because SA-row order is not text order.)"""
    B = read_len.shape[0]
    S, C = pos_f.shape[1], pos_f.shape[2]
    qp_f = jnp.broadcast_to(qpos_grid[None, :, None], (B, S, C)
                            ).astype(jnp.int32)
    qp_r = read_len[:, None, None] - qp_f - k                     # rc coords
    ok_f = ok_f & win_ok[:, :, None]
    ok_r = ok_r & win_ok[:, :, None]

    def k1(qp, strand, ok):
        v = (jnp.int32(strand) << _QPOS_BITS) | qp
        return jnp.where(ok, v, INVALID_K1)

    key1 = jnp.concatenate(
        [k1(qp_f, 0, ok_f).reshape(B, S * C),
         k1(qp_r, 1, ok_r).reshape(B, S * C)], axis=1)
    key2 = jnp.concatenate(
        [pos_f.reshape(B, S * C), pos_r.reshape(B, S * C)], axis=1)

    key1, key2 = jax.lax.sort((key1, key2), dimension=1, num_keys=1,
                              is_stable=True)
    key1 = key1[:, :max_hits]
    key2 = key2[:, :max_hits]

    valid = key1 < INVALID_K1
    qpos = jnp.where(valid, key1 & ((1 << _QPOS_BITS) - 1), 0)
    strand = jnp.where(valid, key1 >> _QPOS_BITS, 0)
    rpos = jnp.where(valid, key2, jnp.uint32(0))
    return {"qpos": qpos, "rpos": rpos, "strand": strand, "valid": valid}


@functools.partial(jax.jit, static_argnames=("k", "cands_per_seed",
                                             "max_hits"))
def seed_hits_direct(read_codes, read_len, qpos_grid, dense_starts,
                     dense_counts, pos16, *, k, cands_per_seed,
                     max_hits):
    """seed_hits with direct-address lookup (dense 4^k start/count
    tables + 16-wide position records) — same output contract, record
    gathers instead of a 23-step binary search per window."""
    C = cands_per_seed
    win, win_ok = extract_windows(read_codes, read_len, qpos_grid, k)
    key_f, key_r = window_keys(win, k)
    rot = seed_rotation(jnp.asarray(qpos_grid))
    pos_f, ok_f = table_lookup_direct(key_f, dense_starts, dense_counts,
                                      pos16, C, rot=rot)
    pos_r, ok_r = table_lookup_direct(key_r, dense_starts, dense_counts,
                                      pos16, C, rot=rot)
    return pack_hits(qpos_grid, read_len, pos_f, ok_f, pos_r, ok_r, win_ok,
                     k=k, max_hits=max_hits)


@functools.partial(jax.jit, static_argnames=("k", "cands_per_seed",
                                             "max_hits"))
def seed_hits(read_codes, read_len, qpos_grid, idx_keys, idx_starts,
              idx_counts, idx_positions, *, k, cands_per_seed, max_hits):
    """Compute seed hits for a batch of reads.

    Args:
      read_codes: int32[B, L] nt4 codes, padded with 4 (N).
      read_len:   int32[B].
      qpos_grid:  int32[S] static sample positions (window starts).
      idx_keys/starts/counts: KmerIndex arrays (device-resident).
      idx_positions: uint32[P] reference positions.
      k, cands_per_seed, max_hits: static config.

    Returns dict: qpos int32[B,H], rpos uint32[B,H] (bit-pattern),
    strand int32[B,H], valid bool[B,H]; sorted by (strand, qpos, rpos).
    """
    C = cands_per_seed
    win, win_ok = extract_windows(read_codes, read_len, qpos_grid, k)
    key_f, key_r = window_keys(win, k)
    rot = seed_rotation(jnp.asarray(qpos_grid))
    pos_f, ok_f = table_lookup(key_f, idx_keys, idx_starts, idx_counts,
                               idx_positions, C, rot=rot)
    pos_r, ok_r = table_lookup(key_r, idx_keys, idx_starts, idx_counts,
                               idx_positions, C, rot=rot)
    return pack_hits(qpos_grid, read_len, pos_f, ok_f, pos_r, ok_r, win_ok,
                     k=k, max_hits=max_hits)


def make_qpos_grid(bucket_len: int, k: int, step: int):
    """Static sample grid for a read-length bucket."""
    import numpy as np
    n = max(1, (bucket_len - k) // step + 1)
    return np.arange(n, dtype=np.int32) * step


# number of read segments for the whole-genome hit quota (seed_hits_fm
# seg_quota): hits are budgeted per (strand, read segment) so random
# genome-scale noise cannot crowd out the read tail or the '-' strand
# before truncation to max_hits (prefix truncation is qpos-ordered).
N_SEG = 16


@functools.partial(jax.jit, static_argnames=("k", "cands_per_seed",
                                             "max_hits", "sa_rate",
                                             "seg_quota", "sub1_cands",
                                             "sub1_k", "sub1_kinds"))
def seed_hits_fm(read_codes, read_len, qpos_grid, fm, *, k, cands_per_seed,
                 max_hits, sa_rate, seg_quota=0, sub1_cands=0, sub1_k=0,
                 sub1_kinds="s"):
    """FM-index variant of seed_hits: same window extraction, same hit
    output contract, but candidate loci come from on-device backward
    search + value-sampled SA resolution (ops/fm.py) instead of the
    sorted k-mer table — the whole-genome path (HBM ~2.3 GB for GRCh38
    vs ~13 GB of position tables).

    Order of operations matters for throughput: SA-row RESOLUTION (a
    sa_rate-step LF gather walk, ~10 gathers/step) is ~25x the cost of
    everything else, so hits are first packed and truncated to
    max_hits per read on their (strand, qpos, SA-row) keys, and only
    the survivors are resolved, then re-sorted into the (strand, qpos,
    text-pos) contract order. When a read saturates max_hits the
    truncation boundary group keeps smallest-SA-row rather than
    smallest-text-pos candidates — both engines share this code, so
    engine agreement is unaffected.

    sub1_cands > 0 additionally searches every window's 1-edit
    variants (ops/fm.py backward_search_1edit — the GEM ≤e-edit seed
    semantic, SURVEY.md §7.2a) keeping sub1_cands candidate loci per
    variant track; used by the adaptive re-seed path for reads past
    the exact-piece error envelope. The variant pieces use their own
    length sub1_k (>= k, default k): with ~8*k1 variant patterns per
    window, random matches scale as ~8*k1*genome/4^k1 per window — k1
    must grow with the genome or variant noise floods max_hits and
    starves the read tail (the same flooding mode round 2 hit with
    exact 13-mers at GRCh38 scale; measured at 1 Mb: k1=13 noise
    collapsed recall 0.95 -> 0.59, k1=15 restored it)."""
    from lamsa_tpu.ops import fm as fmops

    B, L = read_codes.shape
    S = qpos_grid.shape[0]
    C = cands_per_seed

    win, win_ok = extract_windows(read_codes, read_len, qpos_grid, k)
    win_rc = (3 - win[:, :, ::-1]) & 3                            # revcomp

    lo_f, hi_f = fmops.backward_search(win, win_ok, fm, k)
    lo_r, hi_r = fmops.backward_search(win_rc, win_ok, fm, k)

    offs = jnp.arange(C, dtype=jnp.uint32)[None, None, :]
    rot = seed_rotation(jnp.asarray(qpos_grid))

    def cand_rows(lo, hi):
        # same >C-occurrence rotation as the k-mer paths (SA-row order
        # is lexicographic, but always-first-C is still one fixed
        # subset of a repeat family's copies — rotate per seed)
        o0 = candidate_rotation(rot[None, :],
                                (hi - lo).astype(jnp.int32), C)
        rows = lo + o0.astype(jnp.uint32)
        rows = rows[:, :, None] + offs
        return rows, rows < hi[:, :, None]

    rows_f, ok_f = cand_rows(lo_f, hi_f)
    rows_r, ok_r = cand_rows(lo_r, hi_r)
    ok_f = ok_f & win_ok[:, :, None]
    ok_r = ok_r & win_ok[:, :, None]

    qp_f = jnp.broadcast_to(qpos_grid[None, :, None], (B, S, C)
                            ).astype(jnp.int32)
    qp_r = read_len[:, None, None] - qp_f - k

    def k1(qp, strand, ok):
        v = (jnp.int32(strand) << _QPOS_BITS) | qp
        return jnp.where(ok, v, INVALID_K1)

    key1_parts = [k1(qp_f, 0, ok_f).reshape(B, S * C),
                  k1(qp_r, 1, ok_r).reshape(B, S * C)]
    rows_parts = [rows_f.reshape(B, S * C), rows_r.reshape(B, S * C)]

    if sub1_cands:
        C1 = sub1_cands
        ks1 = sub1_k or k
        if ks1 == k:
            win1, win1_ok = win, win_ok
        else:
            win1, win1_ok = extract_windows(read_codes, read_len,
                                            qpos_grid, ks1)
        win1_rc = (3 - win1[:, :, ::-1]) & 3
        lo1f, hi1f = fmops.backward_search_1edit(win1, win1_ok, fm, ks1,
                                                 kinds=sub1_kinds)
        lo1r, hi1r = fmops.backward_search_1edit(win1_rc, win1_ok, fm,
                                                 ks1, kinds=sub1_kinds)
        T = lo1f.shape[-1]
        offs1 = jnp.arange(C1, dtype=jnp.uint32)[None, None, None, :]

        def cand1(lo, hi):
            r = lo[..., None] + offs1                     # (B, S, T, C1)
            return r, (r < hi[..., None]) & win1_ok[:, :, None, None]

        r1f, o1f = cand1(lo1f, hi1f)
        r1r, o1r = cand1(lo1r, hi1r)
        qp1f = jnp.broadcast_to(qp_f[:, :, :1, None], (B, S, T, C1))
        # rc coords use the SUB1 window length (a ks1-long window at
        # forward qp occupies rc-read position L - qp - ks1)
        qp1r = jnp.broadcast_to(
            (read_len[:, None] - qpos_grid[None, :] - ks1)
            .astype(jnp.int32)[:, :, None, None], (B, S, T, C1))
        key1_parts += [k1(qp1f, 0, o1f).reshape(B, S * T * C1),
                       k1(qp1r, 1, o1r).reshape(B, S * T * C1)]
        rows_parts += [r1f.reshape(B, S * T * C1),
                       r1r.reshape(B, S * T * C1)]

    key1 = jnp.concatenate(key1_parts, axis=1)
    rows = jnp.concatenate(rows_parts, axis=1)

    key1, rows = jax.lax.sort((key1, rows), dimension=1, num_keys=1,
                              is_stable=True)
    if seg_quota:
        # whole-genome fairness (see N_SEG): cap hits per (strand,
        # read segment), invalidate the excess, re-compact. The kept
        # subset is a STRATIFIED (strided) sample across the segment's
        # sorted candidates, not the first seg_quota: first-N keeps
        # only the lowest-qpos window(s)' candidates (C=16 per window
        # >= the quota), which clusters survivors at segment starts —
        # measured at config-4 it starved chains of true anchors and
        # carved ~500-base artificial coverage gaps that fired the
        # adaptive gap trigger on EVERY 10 kb read (round 5).
        qp = key1 & ((1 << _QPOS_BITS) - 1)
        seg = jnp.minimum(qp * N_SEG // L, N_SEG - 1)
        gid = jnp.where(key1 < INVALID_K1,
                        (key1 >> _QPOS_BITS) * N_SEG + seg, -1)
        idx = jax.lax.broadcasted_iota(jnp.int32, gid.shape, 1)
        newg = jnp.concatenate(
            [jnp.ones((B, 1), bool), gid[:, 1:] != gid[:, :-1]], axis=1)
        gstart = jax.lax.cummax(jnp.where(newg, idx, -1), axis=1)
        total = gid.shape[1]
        # exclusive suffix-min of group starts = this group's end
        nxt = jnp.where(newg, idx, total)
        pad = jnp.full((B, 1), total, jnp.int32)
        gend = jax.lax.cummin(
            jnp.concatenate([nxt[:, 1:], pad], axis=1), axis=1,
            reverse=True)
        stride = (gend - gstart + seg_quota - 1) // seg_quota
        off = idx - gstart
        drop = (gid >= 0) & ((off % jnp.maximum(stride, 1)) != 0)
        key1 = jnp.where(drop, INVALID_K1, key1)
        key1, rows = jax.lax.sort((key1, rows), dimension=1, num_keys=1,
                                  is_stable=True)
    key1 = key1[:, :max_hits]
    rows = rows[:, :max_hits]

    valid = key1 < INVALID_K1
    rpos = fmops.resolve_rows(rows, valid, fm, sa_rate)           # (B, H)
    key1, rpos = jax.lax.sort((key1, rpos), dimension=1, num_keys=2)

    qpos = jnp.where(valid, key1 & ((1 << _QPOS_BITS) - 1), 0)
    strand = jnp.where(valid, key1 >> _QPOS_BITS, 0)
    rpos = jnp.where(valid, rpos, jnp.uint32(0))
    return {"qpos": qpos, "rpos": rpos, "strand": strand, "valid": valid}
