"""On-device FM-index operations: batched backward search + SA resolve.

Device mirror of index/fmindex.py host queries, built entirely from
gathers, popcounts and fixed-trip loops (XLA-friendly — the same
"pure gathers" design SURVEY.md section 7 step 2a prescribes). All row
arithmetic is uint32 (rows < 2^32; no x64 mode).

GATHER BATCHING: a rank step is a chain of dependent random reads, so
the layout packs everything one rank step touches into ONE gathered
record:

  * blk  uint32[ncp, 8]  — per 64-base BWT block: 4 Occ checkpoint
    words + the 4 packed BWT words. rank(c, i) is one row gather plus
    dense selects/popcounts (was 5 elementwise gathers); an LF-walk
    step reuses the same record for bwt_char + rank (was ~7).
  * mblk uint32[ncp2, 4] — per 64-row mark block: rank checkpoint +
    2 mark bitvector words (+ pad to a 4-lane record). mark bit and
    mark rank share one gather (was 4).

rank(c, i): block-record gather + popcount of 2-bit-matched lanes.
Resolve: fixed SA_RATE-trip LF-walk to a value-sampled row (guaranteed
to land by construction) — 3 record gathers per step (blk, mblk,
ssa_pos) instead of ~10 elementwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

U1 = jnp.uint32(1)
FULL = jnp.uint32(0xFFFFFFFF)


def _sel4(rec4, idx):
    """rec4[..., idx] without a gather: 4-lane masked sum (dense)."""
    lane = jnp.arange(4, dtype=jnp.int32)
    return jnp.sum(jnp.where(lane == idx[..., None].astype(jnp.int32),
                             rec4, jnp.uint32(0)),
                   axis=-1, dtype=jnp.uint32)


def _rank_rec(rec, c, rem):
    """# of char c within a block record given rem = bases into the
    block: Occ checkpoint lane c + masked popcount over the 4 packed
    BWT words (all dense ops; rec is the (…, 8) gathered record)."""
    base = _sel4(rec[..., :4], c)
    pat = jnp.uint32(0x55555555) * c.astype(jnp.uint32)
    total = jnp.zeros_like(base)
    for o in range(4):
        w = rec[..., 4 + o]
        y = ~(w ^ pat)
        m = y & (y >> U1) & jnp.uint32(0x55555555)
        cov = jnp.clip(rem - 16 * o, 0, 16)
        mask = jnp.where(cov >= 16, FULL,
                         (U1 << (2 * cov).astype(jnp.uint32)) - U1)
        total += jax.lax.population_count(m & mask)
    return base + total


def _rank(c, i, primary, blk):
    """# of char c in full-BWT rows [0, i) (sentinel excluded).
    c: int32[...], i: uint32[...]. One record gather."""
    ip = i - (i > primary).astype(jnp.uint32)
    rec = blk[(ip >> 6).astype(jnp.int32)]
    rem = (ip & jnp.uint32(63)).astype(jnp.int32)
    return _rank_rec(rec, c, rem)


def _mark_bit_and_rank(r, mblk):
    """(marked?, # marked rows before r) from ONE mark-block record."""
    rec = mblk[(r >> 6).astype(jnp.int32)]
    base = rec[..., 0]
    rem = (r & jnp.uint32(63)).astype(jnp.int32)
    total = jnp.zeros_like(base)
    for o in range(2):                                # 2 words of 32 rows
        w = rec[..., 1 + o]
        cov = jnp.clip(rem - 32 * o, 0, 32)
        mask = jnp.where(cov >= 32, FULL,
                         (U1 << cov.astype(jnp.uint32)) - U1)
        total += jax.lax.population_count(w & mask)
    wsel = jnp.where((r & jnp.uint32(32)) != 0, rec[..., 2], rec[..., 1])
    bit = ((wsel >> (r & jnp.uint32(31))) & U1).astype(jnp.bool_)
    return bit, base + total


def backward_search(win, win_ok, fm, k: int):
    """Exact backward search of (…, k) nt4 windows.

    fm: dict of device arrays {C (uint32[5]), primary (uint32 scalar),
    blk (uint32[ncp, 8]), n_rows (uint32 scalar)}.
    Returns (lo, hi) uint32 row intervals; empty (0,0) where invalid.
    """
    win = jnp.asarray(win)
    shape = win.shape[:-1]
    lo0 = jnp.zeros(shape, jnp.uint32)
    hi0 = jnp.broadcast_to(fm["n_rows"], shape)

    def step(t, carry):
        lo, hi, ok = carry
        c = jnp.clip(jnp.take(win, k - 1 - t, axis=-1), 0, 3)
        lo = fm["C"][c] + _rank(c, lo, fm["primary"], fm["blk"])
        hi = fm["C"][c] + _rank(c, hi, fm["primary"], fm["blk"])
        return lo, hi, ok & (lo < hi)

    lo, hi, ok = jax.lax.fori_loop(0, k, step, (lo0, hi0, win_ok))
    lo = jnp.where(ok, lo, 0)
    hi = jnp.where(ok, hi, 0)
    return lo, hi


def edit1_tracks(k: int, kinds: str = "s"):
    """Static track tables for backward_search_1edit: patterns at edit
    distance exactly 1 from a k-length piece. kinds selects families:
      's': 3k substitution tracks (pattern length k): position p gets
        win[p] ^ x, x in 1..3;
      'd': k deletion tracks (length k - 1): read char j dropped;
      'i': 4(k-1) insertion tracks (length k + 1): reference has an
        extra char c in gap j (interior gaps only — edge gaps are
        covered by the shorter exact suffix/prefix of neighbors).
    Production default is subs-only: indel-variant anchors sit on
    ±1-shifted diagonals, which breaks the pipeline's blocks-are-
    coordinate-exact invariant (overlapping off-diagonal anchors are
    conflict-dropped in skeleton.anchors_to_blocks) — measured as a
    net recall LOSS (20% error: 1.000 subs-only vs 0.934 with 'sdi').
    Returns int32 arrays (typ, pos, aux, length) of shape (T,)."""
    import numpy as np
    typ, pos, aux, ln = [], [], [], []
    if "s" in kinds:
        for p in range(k):
            for x in (1, 2, 3):
                typ.append(0), pos.append(p), aux.append(x), ln.append(k)
    if "d" in kinds:
        for j in range(k):
            typ.append(1), pos.append(j), aux.append(0), ln.append(k - 1)
    if "i" in kinds:
        for j in range(1, k):
            for c in range(4):
                typ.append(2), pos.append(j), aux.append(c)
                ln.append(k + 1)
    return (np.asarray(typ, np.int32), np.asarray(pos, np.int32),
            np.asarray(aux, np.int32), np.asarray(ln, np.int32))


def backward_search_1edit(win, win_ok, fm, k: int, kinds: str = "s"):
    """1-edit-tolerant backward search: each (…, k) window is searched
    as T independent exact tracks covering the selected edit-distance-1
    pattern families (edit1_tracks above). Returns (lo, hi) uint32 of
    shape (…, T); empty (0, 0) where invalid or no match.

    This is SURVEY.md §7.2a's pigeonhole construction taken one level
    down (the GEM ≤e-edit seed semantic): the exact-piece scheme loses
    every window containing an error, while tolerating one edit
    multiplies surviving windows ~5-6x on a 28%-total-error read
    (P(≤1 edit in 15 bases) ≈ 7.8% vs 1.4% clean). Tracks are
    data-parallel lanes of the same rank recurrence as backward_search,
    run for k+1 steps with shorter tracks masked when exhausted; each
    track's character stream is synthesized inside the scan (no
    (…, T, k) pattern materialization). Every variant differs from the
    exact piece, so candidate sets are near-disjoint from the exact
    search's. Cost: ~8k x the exact search's rank gathers — the
    adaptive re-seed path only (pipeline/aln.py), never the hot
    path."""
    win = jnp.asarray(win)
    shape = win.shape[:-1]
    typ, pos, aux, ln = (jnp.asarray(a) for a in edit1_tracks(k, kinds))
    T = typ.shape[0]
    # substituted char per (…, track): win[pos] ^ aux for sub tracks
    sub_c = (jnp.clip(jnp.take(win, pos, axis=-1), 0, 3) ^ aux) & 3
    lo0 = jnp.zeros(shape + (T,), jnp.uint32)
    hi0 = jnp.broadcast_to(fm["n_rows"], shape + (T,))
    ok0 = jnp.broadcast_to(win_ok[..., None], shape + (T,))

    def step(t, carry):
        lo, hi, ok = carry
        p = ln - 1 - t                       # (T,) pattern position
        active = p >= 0
        # pattern[p] -> read-window index (del skips win[pos], ins
        # shifts back past the inserted gap)
        idx = p + ((typ == 1) & (p >= pos)) - ((typ == 2) & (p > pos))
        c = jnp.take(win, jnp.clip(idx, 0, k - 1), axis=-1)
        c = jnp.where((typ == 0) & (p == pos), sub_c, c)
        c = jnp.where((typ == 2) & (p == pos), aux, c)
        c = jnp.clip(c, 0, 3)
        lo_n = fm["C"][c] + _rank(c, lo, fm["primary"], fm["blk"])
        hi_n = fm["C"][c] + _rank(c, hi, fm["primary"], fm["blk"])
        return (jnp.where(active, lo_n, lo), jnp.where(active, hi_n, hi),
                ok & (~active | (lo_n < hi_n)))

    lo, hi, ok = jax.lax.fori_loop(0, k + 1, step, (lo0, hi0, ok0))
    return jnp.where(ok, lo, 0), jnp.where(ok, hi, 0)


def resolve_rows(rows, valid, fm, sa_rate: int):
    """Rows -> text positions via fixed-trip LF-walk (<= sa_rate steps
    to a value-sampled row). Returns uint32 positions (0 where
    invalid). 3 record gathers per step (blk + mblk + ssa_pos)."""
    r0 = jnp.where(valid, rows, 0).astype(jnp.uint32)

    def step(_, carry):
        r, pos, done, steps = carry
        at_p = r == fm["primary"]
        mk, mrank = _mark_bit_and_rank(r, fm["mblk"])
        newly = ~done & (at_p | mk)
        pos = jnp.where(newly & at_p, steps, pos)
        samp = fm["ssa_pos"][mrank] + steps
        pos = jnp.where(newly & ~at_p, samp, pos)
        done = done | newly
        # LF step: ONE block-record gather serves bwt_char AND rank
        rp = r - (r > fm["primary"]).astype(jnp.uint32)
        rec = fm["blk"][(rp >> 6).astype(jnp.int32)]
        w = _sel4(rec[..., 4:8], (rp >> 4) & jnp.uint32(3))
        c = ((w >> (2 * (rp & jnp.uint32(15)))) & jnp.uint32(3)) \
            .astype(jnp.int32)
        rem = (rp & jnp.uint32(63)).astype(jnp.int32)
        r_next = fm["C"][c] + _rank_rec(rec, c, rem)
        return jnp.where(done, r, r_next), pos, done, steps + 1

    _, pos, _, _ = jax.lax.fori_loop(
        0, sa_rate + 1, step,
        (r0, jnp.zeros_like(r0), ~valid, jnp.zeros_like(r0)))
    return jnp.where(pos >= fm["n_rows"], pos - fm["n_rows"], pos)


def device_arrays(fm_host) -> dict:
    """FmIndex (host) -> device array dict for the functions above
    (interleaved block records; see module docstring)."""
    import numpy as np

    occ = fm_host.occ.astype(np.uint32)               # (ncp, 4)
    ncp = occ.shape[0]
    bwt = np.zeros(ncp * 4, np.uint32)
    bwt[:len(fm_host.bwt2)] = fm_host.bwt2
    blk = np.concatenate([occ, bwt.reshape(ncp, 4)], axis=1)

    rankcp = fm_host.ssa_rankcp.astype(np.uint32)     # (ncp2,)
    ncp2 = rankcp.shape[0]
    marks = np.zeros(ncp2 * 2, np.uint32)
    marks[:len(fm_host.ssa_marks)] = fm_host.ssa_marks
    mblk = np.concatenate(
        [rankcp[:, None], marks.reshape(ncp2, 2),
         np.zeros((ncp2, 1), np.uint32)], axis=1)     # 4-lane records

    return {
        "C": jnp.asarray(fm_host.C.astype(np.uint32)),
        "primary": jnp.uint32(fm_host.primary),
        "n_rows": jnp.uint32(fm_host.n + 1),
        "blk": jnp.asarray(blk),
        "mblk": jnp.asarray(mblk),
        "ssa_pos": jnp.asarray(fm_host.ssa_pos),
    }
