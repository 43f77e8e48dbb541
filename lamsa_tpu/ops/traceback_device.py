"""Device CIGAR traceback in plain JAX (the accelerator path's walk).

The DP's direction bytes are ~1 byte per cell; only this walk's compact
result crosses to the host (ops/banded_sw.py `compact_encode`).

Lockstep walk: in the banded layout every traceback row visit is one
optional run of D steps (the E state moving left within the row)
followed by exactly one up-step (M keeps the lane, I moves to lane+1).
So every instance climbs exactly one DP row per step, and the walk is a
`lax.scan` over rows M..1 carrying (alive, in-F-state, lane) per
instance. The D run starting at lane d covers lanes x+1..d, where x is
the highest lane below d whose chain bit is clear; chain bit
c[y] = is_e[y] | e_ext[y+1] says a D at lane y+1 is followed by one at
lane y.

Outputs per instance:
  steps[b, r-1] for DP row r: d_count | op << 16, op 0=M, 1=I,
    2=inactive (row above the start cell);
  term[b, 0] = terminal j at row 0 (leading D count of the CIGAR);
  term[b, 1] = final lane (diagnostic).
Host decoding: ops/traceback.py::decode_steps (NumPy spec) or the
native decoder, both via the compact wire. The host spec this walk must
reproduce is ops/traceback.py::traceback_banded.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

OP_STEP_M = 0
OP_STEP_I = 1
OP_INACTIVE = 2


def _lane(v, idx):
    """v[b, idx[b]] for a (B, W) array (idx clipped into the band)."""
    W = v.shape[1]
    return jnp.take_along_axis(v, jnp.clip(idx, 0, W - 1)[:, None],
                               axis=1)[:, 0]


def traceback_walk(dirs, lo, start_i, start_d):
    """Walk the direction bytes from (start_i, start_d) back to row 0.

    dirs: uint8[M, B, W], row r at index r-1, in the order the XLA
    DP's row scan emits them (ops/banded_sw_xla.py banded_sw_rows).
    lo, start_i, start_d: int32[B]. An instance with start_i == 0 does
    not walk; its terminal is lo + start_d.
    Returns (steps int32[B, M], term int32[B, 2])."""
    M, B, W = dirs.shape
    lanes = jnp.arange(W, dtype=jnp.int32)[None, :]
    si = jnp.asarray(start_i, jnp.int32)
    sd = jnp.asarray(start_d, jnp.int32)

    def row(carry, xs):
        alive, in_f, d = carry
        byte, r = xs
        byte = byte.astype(jnp.int32)
        src = byte & 3
        e_ext = (byte >> 2) & 1
        f_ext = (byte >> 3) & 1

        starting = (si == r) & ~alive
        d = jnp.where(starting, sd, d)
        alive = alive | starting
        in_f = in_f & ~starting

        # H state: D run from lane d down to the first clear chain bit
        is_e = src == 1
        chain = is_e | jnp.concatenate(
            [e_ext[:, 1:] == 1, jnp.zeros((B, 1), jnp.bool_)], axis=1)
        brk = jnp.max(jnp.where((lanes < d[:, None]) & ~chain, lanes, -1),
                      axis=1)
        start_e = _lane(src, d) == 1
        count = jnp.where(start_e, d - brk, 0)
        x = d - count                       # exit lane, state H there
        h_is_m = _lane(src, x) == 0         # else src F: one I step
        h_lane = jnp.where(h_is_m, x, x + 1)
        h_f = ~h_is_m & (_lane(f_ext, x) == 1)

        # F state: one I step, no D run
        op = jnp.where(in_f | ~h_is_m, OP_STEP_I, OP_STEP_M)
        count = jnp.where(in_f, 0, count)
        new_d = jnp.where(in_f, d + 1, h_lane)
        new_f = jnp.where(in_f, _lane(f_ext, d) == 1, h_f)

        word = jnp.where(alive, count | (op << 16), OP_INACTIVE << 16)
        d = jnp.where(alive, new_d, d)
        in_f = jnp.where(alive, new_f, in_f)
        return (alive, in_f, d), word

    init = (jnp.zeros((B,), jnp.bool_), jnp.zeros((B,), jnp.bool_), sd)
    rows = jnp.arange(1, M + 1, dtype=jnp.int32)
    (_, _, d_end), words = jax.lax.scan(row, init, (dirs, rows),
                                        reverse=True)
    term = jnp.stack([lo + d_end, d_end], axis=1).astype(jnp.int32)
    return words.T, term
