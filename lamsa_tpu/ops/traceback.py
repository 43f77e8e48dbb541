"""Host-side CIGAR traceback over banded direction arrays.

The XLA DP (ops/banded_sw_xla.py) emits per-cell direction bytes in
band-lane coordinates (lane d of row i = cell (i, j) with j = i + lo +
d; byte layout in ops/oracle.py). The CPU engine walks them on the host
— O(m + n) per gap, tiny compared to the O(m * W) DP (SURVEY.md
section 7 "Hard parts" item 2) — with the native C++ walk in
native/lamsa_native.cpp (traceback_banded); this module is the NumPy
fallback and the semantics spec, which the device walk
(ops/traceback_device.py) also reproduces.
"""

from __future__ import annotations

import numpy as np

from lamsa_tpu.io.sam import OP_D, OP_I, OP_M
from lamsa_tpu.ops.oracle import E_EXT_BIT, F_EXT_BIT, H_FROM_DIAG, H_FROM_E


def traceback_banded(dirs: np.ndarray, lo: int, i: int, j: int):
    """Walk from DP cell (i, j) back to (0, 0).

    Args:
      dirs: uint8[M, W] direction bytes for one instance (row r at
            index r-1).
      lo:   band low offset.
      i, j: end cell (for global: i=m, j=n; for extend: the best cell).

    Returns CIGAR [(op, len), ...] in forward order.
    """
    ops: list[list[int]] = []

    def push(op, ln=1):
        if ops and ops[-1][0] == op:
            ops[-1][1] += ln
        else:
            ops.append([op, ln])

    state = 0  # 0=H, 1=E, 2=F
    while i > 0 and j > 0:
        d = int(dirs[i - 1, j - i - lo])
        if state == 0:
            src = d & 3
            if src == H_FROM_DIAG:
                push(OP_M)
                i -= 1
                j -= 1
            elif src == H_FROM_E:
                state = 1
            else:
                state = 2
        elif state == 1:
            push(OP_D)
            if not (d & E_EXT_BIT):
                state = 0
            j -= 1
        else:
            push(OP_I)
            if not (d & F_EXT_BIT):
                state = 0
            i -= 1
    if j > 0:
        push(OP_D, j)
    if i > 0:
        push(OP_I, i)
    return [(op, ln) for op, ln in reversed(ops)]


def decode_steps(steps_row: np.ndarray, term_row: np.ndarray,
                 start_i: int):
    """Decode one instance's on-device traceback output
    (ops/traceback_device.py) into a forward CIGAR.

    steps_row[r-1] for DP row r holds (d_count | op << 16); term_row[0]
    is the terminal j at row 0 (leading D run). Must produce the exact
    CIGAR traceback_banded() produces from the same direction data.
    """
    ops: list[list[int]] = []

    def push(op, ln):
        if ln <= 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1][1] += ln
        else:
            ops.append([op, ln])

    for r in range(int(start_i), 0, -1):
        word = int(steps_row[r - 1])
        step_op = word >> 16
        count = word & 0xFFFF
        push(OP_D, count)
        if step_op == 0:
            push(OP_M, 1)
        elif step_op == 1:
            push(OP_I, 1)
    push(OP_D, int(term_row[0]))
    return [(op, ln) for op, ln in reversed(ops)]


def decode_steps16(steps16_row: np.ndarray, term_row: np.ndarray,
                   start_i: int):
    """Decode the 16-bit-packed step stream (two DP rows per int32,
    each (count:14 | op:2)); see ops/banded_sw.py _dp_tb_fused."""
    ops: list[list[int]] = []

    def push(op, ln):
        if ln <= 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1][1] += ln
        else:
            ops.append([op, ln])

    for r in range(int(start_i), 0, -1):
        w = int(steps16_row[(r - 1) >> 1]) & 0xFFFFFFFF
        s16 = (w >> (16 * ((r - 1) & 1))) & 0xFFFF
        count = s16 & 0x3FFF
        step_op = s16 >> 14
        push(OP_D, count)
        if step_op == 0:
            push(OP_M, 1)
        elif step_op == 1:
            push(OP_I, 1)
    push(OP_D, int(term_row[0]))
    return [(op, ln) for op, ln in reversed(ops)]


def decode_compact(opbits_row: np.ndarray, events_row: np.ndarray,
                   term0: int, start_i: int, n_ev: int,
                   wide: bool = False):
    """Decode one instance's compact device-traceback output: op bitmap
    (bit idx = DP row idx, 1 = I step, 0 = M step) plus sparse D
    events, row-ascending. Narrow events (M <= 2048 buckets) are
    (row_idx << 5) | d_count with d_count <= 30 (events_row is the
    uint16 view of the packed event words); wide events (M > 2048,
    ops/banded_sw.py compact_wide) are one int32 per word,
    (row_idx << 13) | d_count with d_count <= 8191. Returns None when
    the instance overflowed on device — more events than the budget,
    or a D run too long (n_ev sentinel 0xFFFF): the caller must
    recompute it. See ops/banded_sw.py::_dp_tb_fused."""
    E = len(events_row)
    if n_ev > E:
        return None
    rsh, cmask = (13, 8191) if wide else (5, 31)
    ops: list[list[int]] = []

    def push(op, ln):
        if ln <= 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1][1] += ln
        else:
            ops.append([op, ln])

    ptr = int(n_ev) - 1
    for r in range(int(start_i), 0, -1):
        idx = r - 1
        if ptr >= 0 and (int(events_row[ptr]) >> rsh) == idx:
            push(OP_D, int(events_row[ptr]) & cmask)
            ptr -= 1
        bit = (int(opbits_row[idx >> 5]) >> (idx & 31)) & 1
        push(OP_I if bit else OP_M, 1)
    push(OP_D, int(term0))
    return [(op, ln) for op, ln in reversed(ops)]
