"""Exact NumPy oracle for banded affine-gap alignment.

This is the framework's stand-in for the reference's ``ksw.c`` kernel
(SURVEY.md section 3.4): a slow, obviously-correct, full-matrix affine
Smith-Waterman with banding and state-aware traceback. The batched XLA
DP (with its host and device tracebacks) is property-tested for
bit-identical scores and CIGARs against this module; the C++ scalar
implementation in ``native/lamsa_native.cpp`` is the measurable CPU
baseline (the reference binary is unavailable — SURVEY.md section 0).

Conventions (shared, framework-wide):
  * query q = read segment (length m, "rows" i), target t = reference
    segment (length n, "columns" j); nt4 codes, code >= 4 never matches.
  * scores: +match; -mismatch; gap of length L costs gap_open + L*gap_ext.
  * E = horizontal gap state (consumes target -> CIGAR D),
    F = vertical gap state (consumes query -> CIGAR I).
  * band: cells with d = j - i outside [band_lo, band_hi] are invalid.
  * tie-breaking (must match the kernels bit-for-bit):
      H source priority on ties: diagonal > E > F;
      gap states prefer extension over re-opening on ties.

Direction byte layout (shared with the kernels and native traceback):
  bits 0-1: H source (0=diag, 1=E/del, 2=F/ins)
  bit 2:    E came from E (extension) rather than H (open)
  bit 3:    F came from F (extension) rather than H (open)
"""

from __future__ import annotations

import numpy as np

from lamsa_tpu.io.sam import OP_D, OP_I, OP_M

NEG_INF = -(1 << 29)

# zdrop (extension termination, SURVEY.md section 3.4 ksw_extend
# semantics) is checked at row-GROUP granularity: after every
# ZDROP_GROUP-th DP row, an extension whose current row max has fallen
# more than zdrop below its running best freezes — later rows update
# neither the best cell nor the to-end row (so the clip decision falls
# back to the best cell). All engines implement this contract
# bit-identically.
ZDROP_GROUP = 32

H_FROM_DIAG = 0
H_FROM_E = 1
H_FROM_F = 2
E_EXT_BIT = 4
F_EXT_BIT = 8


def _score_cell(qc: int, tc: int, match: int, mismatch: int) -> int:
    if qc >= 4 or tc >= 4:
        return -mismatch
    return match if qc == tc else -mismatch


def _run_dp(q, t, scores, band_lo, band_hi):
    """Full 3-state banded DP. Returns (H, E, F, dirs) matrices of shape
    (m+1, n+1); invalid cells hold NEG_INF."""
    match, mismatch, gapo, gape = scores.as_tuple()
    m, n = len(q), len(t)
    H = np.full((m + 1, n + 1), NEG_INF, dtype=np.int64)
    E = np.full((m + 1, n + 1), NEG_INF, dtype=np.int64)
    F = np.full((m + 1, n + 1), NEG_INF, dtype=np.int64)
    dirs = np.zeros((m + 1, n + 1), dtype=np.uint8)

    H[0, 0] = 0
    for j in range(1, n + 1):
        if j - 0 > band_hi:
            break
        E[0, j] = -(gapo + j * gape)
        H[0, j] = E[0, j]
        dirs[0, j] = H_FROM_E | (E_EXT_BIT if j > 1 else 0)
    for i in range(1, m + 1):
        if 0 - i < band_lo:
            break
        F[i, 0] = -(gapo + i * gape)
        H[i, 0] = F[i, 0]
        dirs[i, 0] = H_FROM_F | (F_EXT_BIT if i > 1 else 0)

    for i in range(1, m + 1):
        jlo = max(1, i + band_lo)
        jhi = min(n, i + band_hi)
        for j in range(jlo, jhi + 1):
            d = 0
            # E: gap in query (consume target), from the left.
            e_open = H[i, j - 1] - gapo - gape
            e_ext = E[i, j - 1] - gape
            if e_ext >= e_open:
                E[i, j] = e_ext
                d |= E_EXT_BIT
            else:
                E[i, j] = e_open
            # F: gap in target (consume query), from above.
            f_open = H[i - 1, j] - gapo - gape
            f_ext = F[i - 1, j] - gape
            if f_ext >= f_open:
                F[i, j] = f_ext
                d |= F_EXT_BIT
            else:
                F[i, j] = f_open
            # H: diag > E > F on ties.
            diag = H[i - 1, j - 1] + _score_cell(q[i - 1], t[j - 1],
                                                 match, mismatch)
            best, src = diag, H_FROM_DIAG
            if E[i, j] > best:
                best, src = E[i, j], H_FROM_E
            if F[i, j] > best:
                best, src = F[i, j], H_FROM_F
            H[i, j] = max(best, NEG_INF)
            dirs[i, j] = d | src
    return H, E, F, dirs


def traceback(dirs, i, j) -> list[tuple[int, int]]:
    """Walk direction bytes from cell (i, j) back to (0, 0) -> CIGAR."""
    ops: list[tuple[int, int]] = []

    def push(op):
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))

    state = "H"
    while i > 0 or j > 0:
        d = dirs[i, j]
        if state == "H":
            src = d & 3
            if src == H_FROM_DIAG:
                push(OP_M)
                i, j = i - 1, j - 1
            elif src == H_FROM_E:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            push(OP_D)
            if not (d & E_EXT_BIT):
                state = "H"
            j -= 1
        else:  # F
            push(OP_I)
            if not (d & F_EXT_BIT):
                state = "H"
            i -= 1
    return ops[::-1]


def banded_global(q, t, scores, band_lo=None, band_hi=None):
    """Global banded affine alignment of q vs t.

    Returns (score, cigar). Band defaults to the feasible full band.
    """
    q = np.asarray(q, dtype=np.uint8)
    t = np.asarray(t, dtype=np.uint8)
    m, n = len(q), len(t)
    if band_lo is None:
        band_lo = -m
    if band_hi is None:
        band_hi = n
    if not (band_lo <= 0 and band_hi >= 0 and band_lo <= n - m <= band_hi):
        raise ValueError(
            f"infeasible band [{band_lo},{band_hi}] for m={m}, n={n}")
    if m == 0 and n == 0:
        return 0, []
    H, _, _, dirs = _run_dp(q, t, scores, band_lo, band_hi)
    score = int(H[m, n])
    cig = traceback(dirs, m, n)
    return score, cig


def banded_extend(q, t, scores, band_lo=None, band_hi=None, zdrop=0):
    """Extension alignment anchored at (0, 0) (ksw_extend-style,
    SURVEY.md section 3.4): align a prefix of q against a prefix of t,
    maximizing score over all cells.

    zdrop > 0 enables group-granular extension termination (see
    ZDROP_GROUP above): at each row i that is a multiple of
    ZDROP_GROUP, if max(H[i]) < running_best - zdrop, rows beyond i
    update neither best nor to_end (to_end survives only if already
    reached, i.e. termination at i == m exactly).

    Returns dict with:
      best:    (score, qend, tend) of the max-scoring cell
               (ties -> smaller i, then smaller j),
      to_end:  (score, tend) best cell in the last row (whole query
               consumed; None if the last row is outside the band or
               the extension z-dropped before reaching it),
      cigar_best / cigar_to_end: tracebacks to those cells,
      zstop:   terminating row (None if never terminated).
    The soft-clip decision (use to_end if to_end >= best - end_bonus)
    is made by the caller.
    """
    q = np.asarray(q, dtype=np.uint8)
    t = np.asarray(t, dtype=np.uint8)
    m, n = len(q), len(t)
    if band_lo is None:
        band_lo = -m
    if band_hi is None:
        band_hi = n
    if m == 0:
        return {"best": (0, 0, 0), "to_end": (0, 0),
                "cigar_best": [], "cigar_to_end": [], "zstop": None}
    H, _, _, dirs = _run_dp(q, t, scores, band_lo, band_hi)
    Hv = H.copy()
    Hv[Hv <= NEG_INF] = NEG_INF
    zstop = None
    if zdrop and zdrop > 0:
        row_max = Hv.max(axis=1)
        run_best = int(row_max[0])
        for i in range(1, m + 1):
            run_best = max(run_best, int(row_max[i]))
            if i % ZDROP_GROUP == 0 and row_max[i] < run_best - zdrop:
                zstop = i
                break
    lim = m if zstop is None else zstop
    # best over live rows; tie -> smaller i then smaller j (argmax order).
    flat = int(np.argmax(Hv[:lim + 1]))
    bi, bj = divmod(flat, n + 1)
    best = (int(Hv[bi, bj]), bi, bj)
    out = {"best": best, "cigar_best": traceback(dirs, bi, bj),
           "zstop": zstop}
    last = Hv[m, :]
    if last.max() > NEG_INF and lim >= m:
        tj = int(np.argmax(last))
        out["to_end"] = (int(last[tj]), tj)
        out["cigar_to_end"] = traceback(dirs, m, tj)
    else:
        out["to_end"] = None
        out["cigar_to_end"] = None
    return out
