"""Banded-SW engines: one DP, two tracebacks.

Both engines run the XLA DP (ops/banded_sw_xla.py) and share one
semantic contract (tested bit-identical):
  * CPU reference engine (`run_group_xla`): the DP's direction bytes
    come to the host and the native traceback walks them — used on the
    CPU (tests, dev) and as the spec;
  * accelerator path (`_dp_tb_fused_gather` and friends): DP, clip
    decision, traceback walk (ops/traceback_device.py) and compact
    encoding run in one jit on the GPU; only the compact wire crosses
    to the host, never the ~1 byte/cell direction data.

lamsa_tpu/device.py decides which one runs; DpBatcher
(pipeline/extend.py) calls through this module only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from lamsa_tpu.ops.oracle import NEG_INF


@functools.partial(jax.jit, static_argnames=())
def extract_scores(h_last, m_len, n_len, lo):
    """Device-side score extraction: global score H[m][n] per instance,
    and the best last-row (to-end) cell for extend clip decisions.
    Returns (global_score [B], te_score [B], te_d [B])."""
    B, W = h_last.shape
    d_g = jnp.clip(n_len - m_len - lo, 0, W - 1)
    g = jnp.take_along_axis(h_last, d_g[:, None], axis=1)[:, 0]
    lanes = jnp.arange(W)[None, :]
    j = m_len[:, None] + lo[:, None] + lanes
    valid = (j >= 0) & (j <= n_len[:, None])
    row = jnp.where(valid, h_last, NEG_INF)
    te = jnp.max(row, axis=1)
    te_d = jnp.argmax(row, axis=1).astype(jnp.int32)
    return g, te, te_d


def run_group_xla(q, t_win, m_len, n_len, lo, scores, zdrop=None):
    """XLA engine + host traceback. Returns a 'group result' object the
    batcher post-processes: dict with numpy arrays + a cigar() closure.
    zdrop: optional int32[B] per-instance extension termination
    (0 = off; globals must pass 0)."""
    from lamsa_tpu import native
    from lamsa_tpu.ops.banded_sw_xla import banded_sw_batch

    res = banded_sw_batch(jnp.asarray(q, jnp.int32),
                          jnp.asarray(t_win, jnp.int32), m_len, n_len, lo,
                          zdrop,
                          match=scores.match, mismatch=scores.mismatch,
                          gapo=scores.gap_open, gape=scores.gap_ext)
    g, te, te_d = extract_scores(res["h_last"], m_len, n_len, lo)
    dirs = np.asarray(res["dirs"])
    out = {
        "global_score": np.asarray(g),
        "te_score": np.asarray(te),
        "te_d": np.asarray(te_d),
        "best": np.asarray(res["best"]),
    }

    def cigar(b: int, i: int, j: int):
        return native.traceback_banded(dirs[b], int(lo[b]), i, j)

    return out, cigar


def compact_E(M: int) -> int:
    """Event-slot budget of the compact traceback encoding for an
    M-row bucket. D events are rows whose traceback emits a deletion
    run — one per deletion in the alignment, so the budget only needs
    to cover plausible indel counts (4% deletions on an M-row gap is
    M/25 runs); overflow (> E deletions in one gap, or any run too
    long for the event's count field) is flagged per instance and
    recomputed host-side bit-identically (native banded_sw_tb). Sized
    M/16 + 8 (always even — narrow events pack two per int32 word)."""
    return M // 16 + 8


def compact_wide(M: int) -> bool:
    """Row indices stop fitting the 16-bit narrow event encoding
    ((row << 5) | cnt) above row 2047: buckets beyond that (the
    (5120, 256) chain_max_dist bucket) use wide 32-bit events, one per
    word, (row << 13) | cnt with cnt <= 8191 — which also covers the
    long D runs (up to ~|n-m| ~ chain_diag_slack + drift) such gaps
    legitimately contain, so they never hit the host-recompute path."""
    return M > 2048


def compact_words(M: int) -> int:
    """Event WORDS on the wire for an M-row bucket."""
    E = compact_E(M)
    return E if compact_wide(M) else E // 2


def compact_overflows(cigar, M: int) -> bool:
    """Whether an instance with this (clip-less) CIGAR overflows the
    compact wire of an M-row bucket, i.e. is recomputed on the host:
    more D events than compact_E(M), or a D run longer than the
    event's count field. A leading D run is the row-0 terminal, not an
    event."""
    from lamsa_tpu.io.sam import OP_D, cigar_pairs
    runs = [ln for i, (op, ln) in enumerate(cigar_pairs(cigar))
            if op == OP_D and i > 0]
    cap = 8191 if compact_wide(M) else 30
    return len(runs) > compact_E(M) or any(r > cap for r in runs)


def _dp_tb_core(q, t_win, m_len, n_len, lo, is_global, bonus, *, match,
                mismatch, gapo, gape, zdrop=0):
    """Banded DP -> score extraction -> clip decision -> on-device
    traceback walk -> compact encode (shared by the upload and the
    device-gather entries below). Returns ONE packed int32 array
    (B, M/32 + E/2 + 3):
      [ op bitmap (M/32 words, bit idx = DP row idx, 1 = I step)
      | D events (E/2 words, two uint16 events per word little-endian:
        (row_idx << 5) | d_count with d_count <= 30, row-ascending,
        0xFFFF padding; a run > 30 marks the instance for host
        recompute via the n_ev = 0xFFFF sentinel)
      | tail: term0 | n_ev << 16, start_i | start_d << 16, score ]
    so the host needs exactly one compact transfer per group (~8-12x
    smaller than per-row step words; all tail fields except score fit
    16 bits: term0 <= M + W, si <= M, sd < W, n_ev <= M)."""
    from lamsa_tpu.ops.banded_sw_xla import banded_sw_rows
    from lamsa_tpu.ops.traceback_device import traceback_walk

    # zdrop applies to extensions only (a global gap fill must reach
    # its end regardless of interior dips — SV interiors dip hard)
    zd = jnp.where(is_global, 0, jnp.int32(zdrop))
    res = banded_sw_rows(q, t_win, m_len, n_len, lo, zd, match=match,
                         mismatch=mismatch, gapo=gapo, gape=gape)
    g, te, te_d = extract_scores(res["h_last"], m_len, n_len, lo)
    best = res["best"]
    te_j = m_len + lo + te_d
    # reachability guard: dead last rows stay near NEG_INF; legitimate
    # scores are always > -29000 (same test as the CPU engine)
    use_te = (te > -29000) & (te >= best[:, 0] - bonus)
    si_ext = jnp.where(use_te, m_len, best[:, 1])
    sj_ext = jnp.where(use_te, te_j, best[:, 1] + lo + best[:, 2])
    sc_ext = jnp.where(use_te, te, best[:, 0])
    si = jnp.where(is_global, m_len, si_ext)
    sj = jnp.where(is_global, n_len, sj_ext)
    score = jnp.where(is_global, g, sc_ext)
    sd = (sj - si - lo).astype(jnp.int32)
    si = si.astype(jnp.int32)
    steps, term = traceback_walk(res["dirs"], lo, si, sd)
    return compact_encode(steps, term, si, sd, score)


def compact_encode(steps, term, si, sd, score):
    """Pack per-row step words + terminals into the compact wire format
    (see _dp_tb_core docstring). Pure jnp; unit-tested round-trip
    against the step-word decoder on CPU (tests/test_compact_tb.py).
    Buckets with M > 2048 switch to wide 32-bit events (compact_wide):
    narrow (row << 5) | cnt events overflow 16 bits at row 2048."""
    B, M = steps.shape
    E = compact_E(M)
    idxr = jax.lax.broadcasted_iota(jnp.int32, (B, M), 1)
    active = idxr < si[:, None]          # rows the walk visited
    op = steps >> 16
    cnt = steps & 0xFFFF
    ibit = (active & (op == 1)).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    opbits = jax.lax.bitcast_convert_type(
        jnp.sum(ibit.reshape(B, M // 32, 32) << shifts[None, None, :],
                axis=2), jnp.int32)
    ev = active & (cnt > 0) & (op != 2)
    if compact_wide(M):
        big = ev & (cnt > 8191)          # 13-bit wide count field
        evw = jnp.where(ev & ~big, (idxr << 13) | cnt,
                        jnp.int32(0x7FFFFFFF))
        evw = jnp.sort(evw, axis=1)[:, :E]   # rows unique -> row order
    else:
        big = ev & (cnt > 30)            # run too long for the 5-bit cnt
        evh = jnp.where(ev & ~big, (idxr << 5) | cnt, jnp.int32(0xFFFF))
        evh = jnp.sort(evh, axis=1)[:, :E]
        pair = evh.reshape(B, E // 2, 2)
        evw = pair[:, :, 0] | (pair[:, :, 1] << 16)
    n_ev = jnp.sum(ev, axis=1).astype(jnp.int32)
    n_ev = jnp.where(jnp.any(big, axis=1), jnp.int32(0xFFFF), n_ev)
    tail = jnp.concatenate(
        [(term[:, 0:1] | (n_ev[:, None] << 16)),
         (si[:, None] | (sd[:, None] << 16)), score[:, None]], axis=1)
    return jnp.concatenate([opbits, evw, tail], axis=1)


@functools.partial(jax.jit, static_argnames=("match", "mismatch", "gapo",
                                             "gape", "zdrop"))
def _dp_tb_fused(q, t_win, m_len, n_len, lo, is_global, bonus, *, match,
                 mismatch, gapo, gape, zdrop=0):
    """Upload entry: q/t_win arrive as host-assembled (B, M) / (B, M+W)
    arrays, possibly uint8 (1 byte/base); cast on device."""
    return _dp_tb_core(q.astype(jnp.int32), t_win.astype(jnp.int32),
                       m_len, n_len, lo, is_global, bonus, match=match,
                       mismatch=mismatch, gapo=gapo, gape=gape,
                       zdrop=zdrop)


# Packed-descriptor wire format (one (B, 4) int32 array per chunk, so a
# chunk costs one small host->device transfer):
#   word 0: q_base (int32 flat-read offset)
#   word 1: t_base (uint32 bit-pattern, genomes to 4 Gb)
#   word 2: m_len | n_len << 16          (both <= M + W < 2^16)
#   word 3: (lo + _LO_BIAS) [13 bits] | q_step<0 << 13 | t_step<0 << 14
#           | q_comp << 15 | is_global << 16 | bonus << 17
_LO_BIAS = 4096


def pack_desc(q_base, q_step, q_comp, t_base, t_step, m_len, n_len, lo,
              is_global, bonus):
    """Host-side descriptor packing (numpy; see wire format above)."""
    B = len(m_len)
    d = np.empty((B, 4), np.int32)
    d[:, 0] = q_base
    d[:, 1] = np.asarray(t_base, np.uint64).astype(np.uint32) \
        .view(np.int32)
    d[:, 2] = m_len | (np.asarray(n_len, np.int64) << 16)
    d[:, 3] = ((np.asarray(lo, np.int64) + _LO_BIAS)
               | ((np.asarray(q_step, np.int64) < 0) << 13)
               | ((np.asarray(t_step, np.int64) < 0) << 14)
               | (np.asarray(q_comp, np.int64) << 15)
               | (np.asarray(is_global, np.int64) << 16)
               | (np.asarray(bonus, np.int64) << 17))
    return d


def unpack_desc(desc):
    """Device-side unpack of pack_desc (jnp)."""
    q_base = desc[:, 0]
    t_base = jax.lax.bitcast_convert_type(desc[:, 1], jnp.uint32)
    m_len = desc[:, 2] & 0xFFFF
    n_len = (desc[:, 2] >> 16) & 0xFFFF
    w3 = desc[:, 3]
    lo = (w3 & 0x1FFF) - _LO_BIAS
    q_step = 1 - 2 * ((w3 >> 13) & 1)
    t_step = 1 - 2 * ((w3 >> 14) & 1)
    q_comp = (w3 >> 15) & 1
    is_global = ((w3 >> 16) & 1).astype(bool)
    bonus = w3 >> 17
    return (q_base, q_step, q_comp, t_base, t_step, m_len, n_len, lo,
            is_global, bonus)


@functools.partial(jax.jit, static_argnames=("M", "W", "match", "mismatch",
                                             "gapo", "gape", "zdrop"))
def _dp_tb_fused_gather(flat_reads, ref_codes, desc, *, M, W, match,
                        mismatch, gapo, gape, zdrop=0):
    """Device-gather entry: q and t windows are assembled ON DEVICE from
    the resident flat read-code array and reference-code array, so the
    per-chunk host->device upload is ONE packed (B, 4) int32 descriptor
    array instead of M + (M+W) codes per instance (SURVEY.md section 5:
    keep host<->device traffic off the hot path).

    Descriptors per instance b (pack_desc wire format above):
      q window element y (0 <= y < m_len) = flat_reads[q_base + q_step*y],
        complemented (3-c for c<4) when q_comp == 1 — this covers both
        strands and the reversed windows of left extensions;
      t window position x (0 <= x < M+W) maps to target offset
        y = x + lo; valid (0 <= y < n_len) positions gather
        ref_codes[t_base + t_step*y] (uint32 math: genomes to 4 Gb),
        invalid ones get the never-matching sentinel 5."""
    (q_base, q_step, q_comp, t_base, t_step, m_len, n_len, lo,
     is_global, bonus) = unpack_desc(desc)
    q, t_win = gather_windows(flat_reads, ref_codes, q_base, q_step,
                              q_comp, t_base, t_step, m_len, n_len, lo,
                              M=M, W=W)
    return _dp_tb_core(q, t_win, m_len, n_len, lo, is_global, bonus,
                       match=match, mismatch=mismatch, gapo=gapo,
                       gape=gape, zdrop=zdrop)


# Code arrays on device are 4-bit packed into int32 WORDS (code i at
# word i >> 3, nibble i & 7): window gathers fetch 8 codes per gathered
# element and expand the nibbles with dense elementwise work, so a
# window costs 8x fewer gathered elements than a byte layout. At the
# 4 Gb uint32 genome ceiling the WORD count is 5e8 < 2^31, so word
# indices are int32-safe at any supported genome size.


def pack_codes_words(codes) -> "np.ndarray":
    """Host-side 4-bit pack of nt codes (0..4) into int32 words, padded
    with 4 (N). len need not be a multiple of 8."""
    codes = np.ascontiguousarray(codes, np.uint8)
    pad = (-len(codes)) % 8
    if pad:
        codes = np.concatenate([codes, np.full(pad, 4, np.uint8)])
    b = codes[0::2] | (codes[1::2] << 4)
    return b.view(np.int32)


def pack_ref_device(codes, rep=None):
    """Place reference codes on device for gather_windows: 4-bit packed
    int32 words (pack_codes_words). rep: optional sharding for
    replication. Half the device bytes of a uint8 layout."""
    return jax.device_put(pack_codes_words(codes), rep)


def flat_nibble(flatw, idx):
    """Gather single codes from a packed int32 word array
    (pack_codes_words layout): code i lives in word i >> 3, nibble
    i & 7. idx is clipped defensively (callers mask out-of-range
    elements). Prefer gather_packed_run for contiguous runs."""
    w = flatw[jnp.clip(idx >> 3, 0, flatw.shape[0] - 1)]
    return (w >> ((idx & 7) * 4)) & 0xF


def _shift_left_rows(x, v, stages=3):
    """out[b, y] = x[b, y + v_b] for per-row v_b in [0, 2**stages):
    log-shift network of dense (roll, select) pairs — no gather.
    Lanes past the end receive wrapped garbage; callers mask."""
    vb = v[:, None]
    for k in range(stages):
        x = jnp.where((vb & (1 << k)) != 0, jnp.roll(x, -(1 << k), axis=1),
                      x)
    return x


def gather_packed_run(words, i0, step, X: int):
    """Extract per-instance contiguous code runs from a packed int32
    word array: out[b, y] = code at flat index i0[b] + step[b]*y for
    y in [0, X). i0 is uint32 (mod-2^32 bit pattern — a negative true
    start wraps; the out-of-range lanes gather clipped garbage and MUST
    be masked by the caller). step is +-1 int32 per instance.

    ONE (B, ceil((X+7)/8)) word gather + dense nibble expansion + a
    3-stage log-shift alignment. Word index (i0 +- 8j) >> 3 is computed
    in uint32: for a wrapped (negative) start the descending/ascending
    words recover the true index exactly once the true flat index turns
    >= 0 (8 * 2^29 == 2^32), so partial head words still decode
    correctly."""
    B = i0.shape[0]
    NW = (X + 14) // 8
    j8 = (8 * jnp.arange(NW, dtype=jnp.int32)).astype(jnp.uint32)[None, :]
    stepu = step.astype(jnp.uint32)[:, None]
    widx = (i0[:, None] + stepu * j8) >> 3
    widx = jnp.minimum(widx, jnp.uint32(words.shape[0] - 1)) \
        .astype(jnp.int32)
    w = words[widx]                               # (B, NW) — the gather
    s = jnp.arange(8, dtype=jnp.int32)[None, None, :]
    fwd = (step > 0)[:, None, None]
    sh = jnp.where(fwd, s, 7 - s) * 4             # reverse nibble order
    nib = (w[:, :, None] >> sh) & 0xF             # for step == -1
    out = nib.reshape(B, NW * 8)
    r = (i0 & jnp.uint32(7)).astype(jnp.int32)
    shift = jnp.where(step > 0, r, 7 - r)
    return _shift_left_rows(out, shift)[:, :X]


def gather_windows(flat_reads, ref_codes, q_base, q_step, q_comp, t_base,
                   t_step, m_len, n_len, lo, *, M, W):
    """On-device window assembly (the spec _build_arrays implements
    host-side); must produce exactly the q / t_win arrays the host
    assembly would upload (tests/test_gather_dispatch.py). flat_reads
    and ref_codes are packed int32 word arrays (pack_codes_words /
    pack_ref_device); both window runs are contiguous, so each is one
    word gather (gather_packed_run)."""
    xq = jnp.arange(M, dtype=jnp.int32)[None, :]
    qg = gather_packed_run(flat_reads, q_base.astype(jnp.uint32),
                           q_step, M)
    qg = jnp.where((q_comp[:, None] == 1) & (qg < 4), 3 - qg, qg)
    q = jnp.where(xq < m_len[:, None], qg, 4)

    xt = jnp.arange(M + W, dtype=jnp.int32)[None, :]
    y = xt + lo[:, None]
    tvalid = (y >= 0) & (y < n_len[:, None])
    # start index t_base + t_step*lo in uint32 (wraps when the band
    # head hangs off the reference start; those lanes are invalid)
    ti0 = t_base + jax.lax.bitcast_convert_type(t_step * lo, jnp.uint32)
    tg = gather_packed_run(ref_codes, ti0, t_step, M + W)
    t_win = jnp.where(tvalid, tg, 5)
    return q, t_win


def global_lo(m, n, W):
    """Band low offset for global instances, rounded down to EVEN. The
    band fixes the DP cells and so the SAM: all engines share this
    formula, parity included, and it must not change. Bucket fit
    guarantees need <= W - 16, so the extra row of band slack always
    exists. Works on scalars and numpy arrays."""
    need = np.abs(n - m) + 1
    lo = np.minimum(0, n - m) - (W - need) // 2
    return lo - (lo & 1)


def dispatch_group(q, t_win, m_len, n_len, lo, is_global, bonus, scores,
                   mesh=None):
    """Async launch of the fused DP+decide+traceback chain; returns the
    device array (no sync). Pair with collect_group. With a mesh, the
    instance dim is sharded across devices (shard_map: each device runs
    the chain on its local shard — read-level data parallelism, zero
    collectives)."""
    if mesh is not None:
        fn = _sharded_upload_fn(mesh, scores.match, scores.mismatch,
                                scores.gap_open, scores.gap_ext,
                                scores.zdrop)
        return fn(q, t_win, m_len, n_len, lo, is_global, bonus)
    return _dp_tb_fused(q, t_win, m_len, n_len, lo, is_global, bonus,
                        match=scores.match, mismatch=scores.mismatch,
                        gapo=scores.gap_open, gape=scores.gap_ext,
                        zdrop=scores.zdrop)


def dispatch_group_gather(desc: np.ndarray, flat_dev, ref_dev, scores,
                          M: int, W: int, mesh=None):
    """Async launch of the device-gather fused chain. `desc` is the
    packed (B, 4) int32 descriptor array (pack_desc). With a mesh,
    descriptors are sharded along the instance dim and the read/ref
    code arrays are replicated (every chip gathers its own shard's
    windows locally — no collectives)."""
    if mesh is not None:
        fn = _sharded_gather_fn(mesh, M, W, scores.match, scores.mismatch,
                                scores.gap_open, scores.gap_ext,
                                scores.zdrop)
        return fn(flat_dev, ref_dev, desc)
    return _dp_tb_fused_gather(
        flat_dev, ref_dev, desc, M=M, W=W,
        match=scores.match, mismatch=scores.mismatch,
        gapo=scores.gap_open, gape=scores.gap_ext, zdrop=scores.zdrop)


@functools.lru_cache(maxsize=None)
def _sharded_gather_fn(mesh, M, W, match, mismatch, gapo, gape, zdrop):
    from jax.sharding import PartitionSpec as P

    from lamsa_tpu.parallel.mesh import DATA_AXIS
    S = P(DATA_AXIS, None)

    def body(flat, refc, desc):
        return _dp_tb_fused_gather(flat, refc, desc, M=M, W=W,
                                   match=match, mismatch=mismatch,
                                   gapo=gapo, gape=gape, zdrop=zdrop)

    # check_vma=False: the body is purely per-shard (no collectives)
    return jax.jit(jax.shard_map(
        body, mesh=mesh, check_vma=False,
        in_specs=(P(), P(), S), out_specs=P(DATA_AXIS, None)))


@functools.lru_cache(maxsize=None)
def _sharded_upload_fn(mesh, match, mismatch, gapo, gape, zdrop):
    from jax.sharding import PartitionSpec as P

    from lamsa_tpu.parallel.mesh import DATA_AXIS
    S = P(DATA_AXIS)

    def body(*args):
        return _dp_tb_fused(*args, match=match, mismatch=mismatch,
                            gapo=gapo, gape=gape, zdrop=zdrop)

    return jax.jit(jax.shard_map(body, mesh=mesh, check_vma=False,
                                 in_specs=(S,) * 7, out_specs=S))


def collect_group(packed_dev, M):
    """Sync one group's packed compact result; returns (cigars, scores,
    si, sd arrays). cigars[b] is None when the instance's event list
    overflowed on device — the batcher recomputes those host-side."""
    from lamsa_tpu import native

    nw = M // 32
    Ew = compact_words(M)
    wide = compact_wide(M)
    packed = np.asarray(packed_dev)
    opbits = packed[:, :nw]
    events = packed[:, nw:nw + Ew]
    tail = packed[:, nw + Ew:]
    term0 = tail[:, 0] & 0xFFFF
    n_ev = (tail[:, 0] >> 16) & 0xFFFF   # 0xFFFF = overflow sentinel
    si = tail[:, 1] & 0xFFFF
    sd = tail[:, 1] >> 16
    score = tail[:, 2]
    cigars = native.decode_compact_batch(opbits, events, term0, si, n_ev,
                                         wide=wide)
    return cigars, score, si, sd
