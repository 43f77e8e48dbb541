"""Device traceback walk (ops/traceback_device.py) vs the host spec
(ops/traceback.py::traceback_banded): decoded CIGARs must be identical
in every (M, W) bucket, for global walks from (m, n) and extension walks
from the best cell, plus the walk's edge cases."""

import jax
import numpy as np
import pytest

from lamsa_tpu import sim
from lamsa_tpu.config import ScoreParams
from lamsa_tpu.ops.banded_sw import global_lo
from lamsa_tpu.ops.banded_sw_xla import banded_sw_batch, make_t_window
from lamsa_tpu.ops.traceback import decode_steps, traceback_banded
from lamsa_tpu.ops.traceback_device import traceback_walk
from lamsa_tpu.pipeline.extend import BUCKETS

S = ScoreParams(match=1, mismatch=3, gap_open=2, gap_ext=1)
KW = dict(match=S.match, mismatch=S.mismatch, gapo=S.gap_open,
          gape=S.gap_ext)
_walk = jax.jit(traceback_walk)


def _content(inst, i):
    """q / t code arrays of dp_instances item i."""
    _kind, m, n, (qb, qs, qc), (tb, ts) = inst["items"][i]
    q = inst["flat"][qb + qs * np.arange(m)]
    if qc:
        q = np.where(q < 4, 3 - q, q)
    return q.astype(np.uint8), inst["ref"][tb + ts * np.arange(n)]


def _batch(pairs, M, W, extend):
    B = len(pairs)
    q = np.zeros((B, M), np.int32)
    t_win = np.zeros((B, M + W), np.int32)
    m_len = np.zeros(B, np.int32)
    n_len = np.zeros(B, np.int32)
    lo = np.zeros(B, np.int32)
    for b, (qq, tt) in enumerate(pairs):
        if extend:          # the aligner caps n <= m + EXT_MARGIN
            tt = tt[:len(qq) + W // 2 - 8]
            lo[b] = -(W // 2)
        else:
            lo[b] = global_lo(len(qq), len(tt), W)
        m_len[b], n_len[b] = len(qq), len(tt)
        q[b, :len(qq)] = qq
        t_win[b] = make_t_window(tt, int(lo[b]), M, W)
    return q, t_win, m_len, n_len, lo


def _check_walk(dirs, lo, start_i, start_d):
    steps, term = _walk(np.ascontiguousarray(np.transpose(dirs, (1, 0, 2))),
                        lo, start_i, start_d)
    steps, term = np.asarray(steps), np.asarray(term)
    for b in range(dirs.shape[0]):
        i, d = int(start_i[b]), int(start_d[b])
        want = traceback_banded(dirs[b], int(lo[b]), i, i + int(lo[b]) + d)
        got = decode_steps(steps[b], term[b], i)
        assert got == want, f"instance {b}: {got[:6]} != {want[:6]}"


@pytest.mark.parametrize("kind", ["global", "extend"])
@pytest.mark.parametrize("M,W", BUCKETS)
def test_walk_matches_host_traceback(M, W, kind):
    rng = np.random.default_rng(M * 7 + W)
    inst = sim.dp_instances(rng, M, W, 4)
    pairs = [_content(inst, i) for i in range(4)]
    q, t_win, m_len, n_len, lo = _batch(pairs, M, W, kind == "extend")
    res = banded_sw_batch(q, t_win, m_len, n_len, lo, **KW)
    dirs = np.asarray(res["dirs"])
    if kind == "global":
        si, sd = m_len, n_len - m_len - lo
    else:
        best = np.asarray(res["best"])
        si, sd = best[:, 1], best[:, 2]
    _check_walk(dirs, lo, si.astype(np.int32), sd.astype(np.int32))


def _small_batch(rng, B=8, M=128, W=128):
    inst = sim.dp_instances(rng, M, W, B)
    return _batch([_content(inst, i) for i in range(B)], M, W, False)


def test_walk_start_row_zero(rng):
    """An instance starting at row 0 walks nothing: every step word is
    inactive and the terminal is lo + start_d (pure leading D)."""
    q, t_win, m_len, n_len, lo = _small_batch(rng)
    dirs = np.asarray(banded_sw_batch(q, t_win, m_len, n_len, lo,
                                      **KW)["dirs"])
    si = m_len.copy()
    sd = (n_len - m_len - lo).astype(np.int32)
    si[2], sd[2] = 0, 70
    si[5], sd[5] = 0, -lo[5]                 # (0, 0): empty CIGAR
    _check_walk(dirs, lo, si, sd)
    steps, term = _walk(np.transpose(dirs, (1, 0, 2)), lo, si, sd)
    assert (np.asarray(steps)[2] >> 16 == 2).all()
    assert int(term[2, 0]) == lo[2] + 70


def test_walk_padded_instances(rng):
    """Padding rows of a chunk (m = n = 0, all-zero direction bytes)
    stay inactive and leave real instances' walks unchanged."""
    q, t_win, m_len, n_len, lo = _small_batch(rng)
    for b in (1, 6):
        q[b], t_win[b] = 0, 5
        m_len[b] = n_len[b] = lo[b] = 0
    dirs = np.asarray(banded_sw_batch(q, t_win, m_len, n_len, lo,
                                      **KW)["dirs"])
    si = m_len.copy()
    sd = (n_len - m_len - lo).astype(np.int32)
    _check_walk(dirs, lo, si, sd)
    steps, term = _walk(np.transpose(dirs, (1, 0, 2)), lo, si, sd)
    assert (np.asarray(steps)[[1, 6]] >> 16 == 2).all()
    assert (np.asarray(term)[[1, 6], 0] == 0).all()


def test_walk_d_run_to_lane_zero():
    """A D run that ends exactly at band lane 0 (the walk's lowest
    lane), then an M step there; and one ending at lane 0 with an I
    step that opens an F chain into the next row."""
    M, W = 4, 16
    dirs = np.zeros((2, M, W), np.uint8)
    d0 = 9
    for b in range(2):
        row = dirs[b, M - 1]                 # DP row M
        row[d0] = 1 | 4                      # H from E, E extends
        row[2:d0] = 4                        # E keeps extending
        row[1] = 0                           # last D: E closes here
        row[0] = 0 if b == 0 else 2 | 8      # exit: M, or I (F extends)
        dirs[b, M - 2, 1] = 8 if b == 1 else 0   # F extends once more
    lo = np.zeros(2, np.int32)               # lane 0 stays off column 0
    si = np.array([M, M], np.int32)
    sd = np.array([d0, d0], np.int32)
    _check_walk(dirs, lo, si, sd)
    steps, _ = _walk(np.transpose(dirs, (1, 0, 2)), lo, si, sd)
    assert int(np.asarray(steps)[0, M - 1]) & 0xFFFF == d0
