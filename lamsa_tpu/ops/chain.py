"""Sparse-DP seed chaining (device kernel).

The reference's chainer builds a DAG over seed hits and runs sparse DP
with a bounded predecessor scan (SURVEY.md sections 2b "Sparse-DP
chainer" and 3.3 "HOT LOOP #2": "for each hit, best predecessor under
co-linearity + gap penalty, O(n * lookback)"). Device version: hits
arrive sorted by (strand, qpos, rpos) (pipeline/seeding.py), and the
predecessor scan is a ``lax.scan`` over hit index with a static lookback
window, each step a dense (B, LOOKBACK) vector op over the whole batch.

Chain-link constraints (which are also the SV split points, SURVEY.md
section 1 stage 2):
  * same strand (strand flip  -> separate chains -> inversion),
  * 0 < dq <= max_dist and 0 < dr <= max_dist
    (ref jumping backwards    -> separate chains -> duplication /
     translocation; huge jump -> separate chains -> deletion / transloc),
  * |dq - dr| <= diag_slack   (large drift -> separate chains ->
     insertion / deletion SV).

Score: f[k] = weight + max(0, max_l f[l] - cost(l, k)) with
cost = |dq - dr| + min(dq, dr) // 64 (drift dominates, mild distance
term). Chain backtracking and multi-chain selection are host-side
(pipeline/skeleton.py) — branchy bookkeeping, not FLOPs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG = -(1 << 29)

# Chain-link cost = |dq - dr| + min(dq, dr) // DIST_COST_DIV: diagonal
# drift is penalized 1:1 (each unit is a real indel the gap filler must
# pay for); plain distance along the diagonal costs 64x less — long
# clean links are normal in long reads, but when two candidate
# predecessors tie on drift the nearer one wins.
DIST_COST_DIV = 64


@functools.partial(jax.jit, static_argnames=("weight", "lookback", "max_dist",
                                             "diag_slack"))
def chain_hits(qpos, rpos, strand, valid, *, weight, lookback, max_dist,
               diag_slack):
    """Sparse-DP chain scores over sorted hits.

    Args:
      qpos, strand: int32[B, H] sorted by (strand, qpos, rpos).
      rpos: uint32[B, H] (bit-pattern; genomes up to 4 Gb).
      valid: bool[B, H].
      weight: static per-anchor score (the k-mer length).

    Returns (f: int32[B, H] chain scores, pred: int32[B, H] predecessor
    hit index or -1).
    """
    B, H = qpos.shape
    LB = lookback
    rpos = rpos.astype(jnp.uint32)

    pad = lambda x, fill: jnp.concatenate(
        [jnp.full((B, LB), fill, x.dtype), x], axis=1)
    qp = pad(qpos, -1)
    rp = pad(rpos, jnp.uint32(0))
    st = pad(strand, -1)
    va = pad(valid.astype(jnp.int32), 0)

    def step(f_pad, kk):
        # window = hits kk-LB .. kk-1 (padded coords kk .. kk+LB)
        qw = jax.lax.dynamic_slice_in_dim(qp, kk, LB, axis=1)
        rw = jax.lax.dynamic_slice_in_dim(rp, kk, LB, axis=1)
        sw = jax.lax.dynamic_slice_in_dim(st, kk, LB, axis=1)
        vw = jax.lax.dynamic_slice_in_dim(va, kk, LB, axis=1)
        fw = jax.lax.dynamic_slice_in_dim(f_pad, kk, LB, axis=1)

        qk = qpos[:, kk][:, None]
        rk = rpos[:, kk][:, None]
        sk = strand[:, kk][:, None]
        vk = valid[:, kk][:, None]

        dq = qk - qw
        # uint32 wraparound subtraction + bitcast = signed 32-bit diff,
        # correct for |true diff| < 2^31 (chain links are local anyway).
        dr = jax.lax.bitcast_convert_type(rk - rw, jnp.int32)
        ok = ((vw > 0) & vk & (sw == sk)
              & (dq > 0) & (dq <= max_dist)
              & (dr > 0) & (dr <= max_dist)
              & (jnp.abs(dq - dr) <= diag_slack))
        cost = jnp.abs(dq - dr) + jnp.minimum(dq, dr) // DIST_COST_DIV
        cand = jnp.where(ok, fw - cost, NEG)
        best = jnp.max(cand, axis=1)
        arg = jnp.argmax(cand, axis=1).astype(jnp.int32)
        f_k = weight + jnp.maximum(best, 0)
        f_k = jnp.where(valid[:, kk], f_k, 0)
        pred_k = jnp.where(best > 0, kk - LB + arg, -1)
        pred_k = jnp.where(valid[:, kk], pred_k, -1)
        f_pad = jax.lax.dynamic_update_slice_in_dim(
            f_pad, f_k[:, None], kk + LB, axis=1)
        return f_pad, (f_k, pred_k)

    f_pad0 = jnp.zeros((B, LB + H), jnp.int32)
    _, (f, pred) = jax.lax.scan(step, f_pad0, jnp.arange(H))
    return jnp.transpose(f), jnp.transpose(pred)
