"""Batched banded affine-gap Smith-Waterman — XLA reference implementation.

This is the batched redesign of the reference's ``ksw.c`` SSE2 kernel
(SURVEY.md section 3.4): instead of per-call SIMD over one
query/target pair, we batch B gap instances and sweep DP rows with the
whole band (W lanes) and the whole batch as vector dimensions, so every
step is a dense (B, W) array op. It is the one DP implementation on
both engines (CPU and GPU) and is property-tested bit-identical to
``ops/oracle.py``.

Band layout ("rolling diagonal"): lane d of row i holds DP cell
(i, j) with j = i + band_lo + d, d in [0, W). Consequences:
  * diagonal neighbor (i-1, j-1) = same lane, previous row;
  * up neighbor (i-1, j)        = lane d+1, previous row (one shift);
  * left neighbor (i, j-1)      = lane d-1, same row.
The in-row left dependency (affine E state) is resolved exactly with an
exclusive prefix-max: E[d] = max_{k>=1} (H'[d-k] - gapo - k*gape) where
H' = max(diag, F). This is exact because opening a gap from a cell whose
value came from E never beats extending that same gap (classic affine
argument); see ops/oracle.py for the shared tie-breaking contract.

Direction bytes match ops/oracle.py bit-for-bit and are traced back on
the host (ops/traceback.py / native C++) or, on the GPU, on the device
(ops/traceback_device.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG_INF = -(1 << 29)
T_SENTINEL = 5  # target padding code; never matches (like N)


@functools.partial(jax.jit, static_argnames=("match", "mismatch", "gapo",
                                             "gape", "with_dirs"))
def banded_sw_batch(q, t_win, m_len, n_len, lo, zdrop=None, *, match,
                    mismatch, gapo, gape, with_dirs=True):
    """Run banded affine DP on a batch of instances.
    Same as banded_sw_rows, with dirs in per-instance (B, M, W) order
    for the host traceback."""
    res = banded_sw_rows(q, t_win, m_len, n_len, lo, zdrop, match=match,
                         mismatch=mismatch, gapo=gapo, gape=gape,
                         with_dirs=with_dirs)
    if with_dirs:
        res["dirs"] = jnp.transpose(res["dirs"], (1, 0, 2))
    return res


def banded_sw_rows(q, t_win, m_len, n_len, lo, zdrop=None, *, match,
                   mismatch, gapo, gape, with_dirs=True):
    """Banded affine DP over rows (traced inside the caller's jit).

    Args:
      q:     int32[B, M]    query nt4 codes, padded arbitrarily.
      t_win: int32[B, M+W]  shifted target window, t_win[b, x] = t[x + lo_b]
                            (out of range -> T_SENTINEL).
      m_len: int32[B]       query lengths (rows actually meaningful).
      n_len: int32[B]       target lengths.
      lo:    int32[B]       band low offset (j - i >= lo); must be <= 0.
      zdrop: int32[B] or None — per-instance extension-termination
             threshold (0/None = disabled): at every ZDROP_GROUP-th row
             (ops/oracle.py contract), an instance whose row max fell
             more than zdrop below its running best freezes (best and
             h_last stop updating; the DP itself keeps running so
             direction bytes match the no-zdrop run bit-for-bit).
      scores: match/mismatch/gapo/gape as python ints (static).

    Returns dict of:
      dirs:   uint8[M, B, W]  direction bytes for rows 1..M (row i at
              index i-1) in the order the row scan emits them; all-zero
              rows beyond m_len. Omitted when with_dirs=False.
      h_last: int32[B, W]     H row at i == m_len (global score row;
              stays NEG_INF if the instance z-dropped before row m).
      best:   int32[B, 3]     (score, i, d) of max-H cell over live rows
              including row 0; ties -> smallest i, then smallest d.
    """
    from lamsa_tpu.ops.oracle import ZDROP_GROUP
    B, M = q.shape
    W = t_win.shape[1] - M
    lanes = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    lo_b = lo[:, None]
    n_b = n_len[:, None]

    # ---- row 0 init: cells (0, j), j = lo + d.
    j0 = lo_b + lanes
    h0 = jnp.where(j0 == 0, 0,
                   jnp.where((j0 >= 1) & (j0 <= n_b),
                             -(gapo + j0 * gape), NEG_INF))
    f0 = jnp.full((B, W), NEG_INF, jnp.int32)

    best0_score = jnp.max(h0, axis=1)
    best0_d = jnp.argmax(h0, axis=1).astype(jnp.int32)
    best0 = jnp.stack(
        [best0_score, jnp.zeros_like(best0_score), best0_d], axis=1)

    h_last0 = jnp.where((m_len == 0)[:, None], h0,
                        jnp.full((B, W), NEG_INF, jnp.int32))
    zd = jnp.zeros((B,), jnp.int32) if zdrop is None \
        else jnp.asarray(zdrop, jnp.int32)
    alive0 = jnp.ones((B,), jnp.bool_)

    def row_step(carry, i):
        h_prev, f_prev, h_last, best, alive = carry
        j = i + lo_b + lanes                       # (B, W) target column
        valid = (j >= 0) & (j <= n_b)

        # shift left: lane d reads lane d+1 of previous row.
        h_up = jnp.concatenate(
            [h_prev[:, 1:], jnp.full((B, 1), NEG_INF, jnp.int32)], axis=1)
        f_up = jnp.concatenate(
            [f_prev[:, 1:], jnp.full((B, 1), NEG_INF, jnp.int32)], axis=1)

        f_ext_bit = f_up >= h_up - gapo            # prefer extension on tie
        f_cur = jnp.maximum(h_up - gapo, f_up) - gape
        f_cur = jnp.maximum(f_cur, NEG_INF)

        # cell (i, j) scores q[i-1] vs t[j-1]; lane d has j-1 = i+lo+d-1,
        # i.e. t_win index (j-1) - lo = i - 1 + d.
        qc = jax.lax.dynamic_index_in_dim(q, i - 1, axis=1, keepdims=True)
        tc = jax.lax.dynamic_slice_in_dim(t_win, i - 1, W, axis=1)
        s = jnp.where((qc == tc) & (qc < 4) & (tc < 4), match, -mismatch)
        diag = h_prev + s                           # same lane, prev row
        diag = jnp.maximum(diag, NEG_INF)

        h_nogap = jnp.maximum(diag, f_cur)
        h_nogap = jnp.where(valid, h_nogap, NEG_INF)

        # E via exclusive prefix max of V = h_nogap + d*gape.
        v = h_nogap + lanes * gape
        p_incl = jax.lax.cummax(v, axis=1)
        p_excl = jnp.concatenate(
            [jnp.full((B, 1), NEG_INF, jnp.int32), p_incl[:, :-1]], axis=1)
        # E[d] = max_{k>=1} (H'[d-k] - gapo - k*gape)
        #      = (max_{d'<d} (H'[d'] + d'*gape)) - d*gape - gapo.
        e_cur = p_excl - lanes * gape - gapo
        e_cur = jnp.where(valid & (j >= 1), jnp.maximum(e_cur, NEG_INF),
                          NEG_INF)
        e_ext_bit = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.bool_),
             v[:, :-1] <= p_excl[:, :-1]], axis=1)

        # H source with tie priority diag > E > F.
        diag_m = jnp.where(valid, diag, NEG_INF)
        f_m = jnp.where(valid, f_cur, NEG_INF)
        h = diag_m
        src = jnp.zeros((B, W), jnp.int32)
        src = jnp.where(e_cur > h, 1, src)
        h = jnp.maximum(h, e_cur)
        src = jnp.where(f_m > h, 2, src)
        h = jnp.maximum(h, f_m)

        in_rows = (i <= m_len)[:, None]             # row exists for instance
        h = jnp.where(in_rows & valid, h, NEG_INF)
        f_m = jnp.where(in_rows & valid, f_m, NEG_INF)

        dirs = (src | (e_ext_bit.astype(jnp.int32) << 2)
                | (f_ext_bit.astype(jnp.int32) << 3)).astype(jnp.uint8)
        dirs = jnp.where(in_rows & valid, dirs, jnp.uint8(0))

        h_last = jnp.where(((i == m_len) & alive)[:, None], h, h_last)

        row_max = jnp.max(h, axis=1)
        row_arg = jnp.argmax(h, axis=1).astype(jnp.int32)
        improve = (row_max > best[:, 0]) & alive
        best = jnp.where(
            improve[:, None],
            jnp.stack([row_max, jnp.full_like(row_arg, i), row_arg], axis=1),
            best)
        # group-boundary zdrop check (after this row's best update;
        # ops/oracle.py ZDROP_GROUP contract)
        alive = alive & ~((i % ZDROP_GROUP == 0) & (zd > 0)
                          & (row_max < best[:, 0] - zd))

        out = dirs if with_dirs else jnp.zeros((B, 0), jnp.uint8)
        return (h, f_m, h_last, best, alive), out

    (h, f, h_last, best, _), dirs = jax.lax.scan(
        row_step, (h0, f0, h_last0, best0, alive0), jnp.arange(1, M + 1))

    result = {"h_last": h_last, "best": best}
    if with_dirs:
        result["dirs"] = dirs                      # (M, B, W)
    return result


def global_score(result, m_len, n_len, lo):
    """Extract the global alignment score H[m][n] per instance."""
    d = n_len - m_len - lo
    return jnp.take_along_axis(
        result["h_last"], d[:, None], axis=1)[:, 0]


def prepare_band(m: int, n: int, W: int) -> int:
    """Choose band lo for a global m-vs-n instance so that both d=0 and
    d=n-m are inside [lo, lo+W-1], centered. Returns lo (<= 0).
    Raises if the instance cannot fit the band."""
    need = abs(n - m) + 1
    if need > W:
        raise ValueError(f"gap too asymmetric for band: m={m} n={n} W={W}")
    slack = W - need
    lo = min(0, n - m) - slack // 2
    return lo


def make_t_window(t, lo: int, M: int, W: int):
    """Build t_win[x] = t[x + lo] with sentinel padding, length M + W."""
    import numpy as np
    out = np.full(M + W, T_SENTINEL, dtype=np.int32)
    src_start = max(0, lo)
    src_end = min(len(t), lo + M + W)
    if src_end > src_start:
        dst_start = src_start - lo
        out[dst_start:dst_start + (src_end - src_start)] = t[src_start:src_end]
    return out
