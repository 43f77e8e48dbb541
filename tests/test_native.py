"""Native C++ components vs their Python spec implementations."""

import numpy as np
import pytest

from lamsa_tpu import native
from lamsa_tpu.config import ScoreParams
from lamsa_tpu.io.fasta import encode_seq, revcomp4
from lamsa_tpu.ops import oracle
from lamsa_tpu.ops.banded_sw_xla import banded_sw_batch
from lamsa_tpu.ops.traceback import decode_steps, traceback_banded
from lamsa_tpu.pipeline.extend import compute_nm
from tests.test_banded_sw_xla import run_batch, mutate

S = ScoreParams()


def cpairs(c):
    """Normalize either CIGAR representation for comparison."""
    from lamsa_tpu.io.sam import cigar_pairs
    return list(cigar_pairs(c))


pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")


def test_encode_and_revcomp():
    s = b"ACGTNacgtnXQ"
    got = native.encode_nt4(s)
    want = np.frombuffer(encode_seq(s), np.uint8)
    assert np.array_equal(got, want)
    rc = native.revcomp4(want)
    assert np.array_equal(rc, np.frombuffer(revcomp4(bytes(want)),
                                            np.uint8))


def test_native_traceback_matches_python(rng):
    W, M = 32, 48
    pairs = []
    for _ in range(12):
        n = int(rng.integers(6, 40))
        t = rng.integers(0, 4, n).astype(np.uint8)
        q = mutate(rng, t, 4)
        if len(q) == 0 or abs(len(t) - len(q)) + 1 > W:
            q = t.copy()
        pairs.append((q, t))
    res, gs, m_len, n_len, lo = run_batch(pairs, M, W, S)
    dirs = np.asarray(res["dirs"])
    for b, (q, t) in enumerate(pairs):
        want = traceback_banded(dirs[b], int(lo[b]), len(q), len(t))
        got = native.traceback_banded(dirs[b], int(lo[b]), len(q), len(t))
        assert cpairs(got) == cpairs(want), b


def test_native_banded_sw_matches_oracle(rng):
    for _ in range(15):
        n = int(rng.integers(5, 60))
        t = rng.integers(0, 4, n).astype(np.uint8)
        q = mutate(rng, t, 5)
        if len(q) == 0:
            q = t.copy()
        lo = min(0, n - len(q)) - 10
        hi = max(0, n - len(q)) + 10
        want_s, want_c = oracle.banded_global(q, t, S, lo, hi)
        got = native.banded_sw_cpu(q, t, S, lo, hi)
        assert got is not None
        assert got[0] == want_s
        assert cpairs(got[1]) == cpairs(want_c)


def _walked(rng, B=16, M=128, W=128):
    """Step words + terminals of the device walk (ops/traceback_device)
    over a batch of mutated global instances."""
    from lamsa_tpu.ops.banded_sw_xla import make_t_window, prepare_band
    from lamsa_tpu.ops.traceback_device import traceback_walk

    q = np.zeros((B, M), np.int32)
    t_win = np.zeros((B, M + W), np.int32)
    m_len = np.zeros(B, np.int32)
    n_len = np.zeros(B, np.int32)
    lo = np.zeros(B, np.int32)
    for b in range(B):
        t = rng.integers(0, 4, int(rng.integers(8, M - 2))).astype(np.uint8)
        qq = mutate(rng, t, max(2, len(t) // 8))[:M]
        if len(qq) == 0 or abs(len(t) - len(qq)) + 1 > W - 8:
            qq = t.copy()
        m_len[b], n_len[b] = len(qq), len(t)
        lo[b] = prepare_band(len(qq), len(t), W)
        q[b, :len(qq)] = qq
        t_win[b] = make_t_window(t, int(lo[b]), M, W)
    res = banded_sw_batch(q, t_win, m_len, n_len, lo, match=S.match,
                          mismatch=S.mismatch, gapo=S.gap_open,
                          gape=S.gap_ext)
    dirs = np.transpose(np.asarray(res["dirs"]), (1, 0, 2))
    si = m_len.copy()
    sd = n_len - m_len - lo
    steps, term = traceback_walk(dirs, lo, si, sd)
    return np.asarray(steps), np.asarray(term), si


def test_native_decode_steps_matches_python(rng):
    B = 16
    steps, term, si = _walked(rng, B)
    got = native.decode_steps_batch(steps, term, si)
    for b in range(B):
        want = decode_steps(steps[b], term[b], int(si[b]))
        assert cpairs(got[b]) == cpairs(want), b


def test_native_nm(rng):
    q = rng.integers(0, 4, 100).astype(np.uint8)
    t = q.copy()
    t[10] = (t[10] + 1) % 4
    cig = [(0, 50), (1, 5), (0, 50)]
    q2 = np.concatenate([q[:50], rng.integers(0, 4, 5).astype(np.uint8),
                         q[50:]])
    want = compute_nm(q2, t, cig)
    got = native.nm_from_cigar(q2, t, cig)
    assert got == want


def test_native_decode_steps16_matches_python(rng):
    from lamsa_tpu.ops.traceback import decode_steps16

    B = 16
    steps, term, si = _walked(rng, B)
    # pack to the 16-bit stream: two rows per int32, (count:14 | op:2)
    count = steps & 0xFFFF
    op = steps >> 16
    s16 = (count & 0x3FFF) | (op << 14)
    steps16 = s16[:, 0::2] | (s16[:, 1::2] << 16)
    got = native.decode_steps16_batch(steps16, term, si)
    for b in range(B):
        want = decode_steps16(steps16[b], term[b], int(si[b]))
        ref = decode_steps(steps[b], term[b], int(si[b]))
        assert cpairs(got[b]) == cpairs(want) == cpairs(ref), b
