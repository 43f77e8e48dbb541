"""Gap filling and end extension (the "frag check" stage).

Mirrors the reference's frag_check + ksw stage (SURVEY.md section 3.3
HOT LOOP #1): within each skeleton part, the gaps between adjacent
anchor blocks are aligned with banded affine-gap DP, the two part ends
are extended with max-cell tracking for soft-clip decisions, and the
per-segment CIGARs are stitched.

Shape discipline (SURVEY.md section 5 "Long-context" row): every
gap/end instance from every read in the batch is thrown into one
``DpBatcher``, bucketed by padded query length into static (M, W)
shapes, and executed as a handful of dense batched calls —
length-bucketed batching keeps the DP lanes dense despite wildly
variable gap sizes. On the GPU the traceback runs on the device and
only a compact wire returns; on the CPU engine it runs on the host over
the returned direction bands (ops/banded_sw.py).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading

import numpy as np

from lamsa_tpu.io.sam import OP_D, OP_I, OP_M, cigar_pairs
from lamsa_tpu.ops.banded_sw_xla import banded_sw_batch, make_t_window
from lamsa_tpu.ops.oracle import NEG_INF
from lamsa_tpu.ops.traceback import traceback_banded

# (max query length, band width) buckets; instances pick the first
# bucket that fits (both kinds, both widths — bands and therefore SAM
# stay bit-identical across engines because the bucket choice is
# engine-independent). Globals and extensions of a bucket share its
# chunks. The last bucket (5120 = 40*128) covers interior gaps up to
# config.chain_max_dist (5000): every chained gap has |n - m| <=
# chain_diag_slack (100) so W=256 always fits — without it such gaps
# would fall to the fabricated-CIGAR fallback.
BUCKETS = ((128, 128), (128, 256), (256, 128), (256, 256), (512, 128),
           (512, 256), (1024, 256), (2048, 256), (5120, 256))

# Largest bucket query length: enqueuers must split anything longer
# (pipeline/aln.py splits oversize gap+anchor units) or it falls to the
# fabricated-CIGAR fallback, which is counted (dp_no_bucket_fallback).
MAX_BUCKET_M = max(M for M, _ in BUCKETS)

# minimum band slack (per side) around the worst-case drift for a
# W=128 global instance; thinner would pinch error excursions
_MIN_SLACK = 24


def _bucket_fits(kind: str, m: int, n: int, M: int, W: int,
                 minw: int = 0) -> bool:
    if m > M or W < minw:
        return False
    if kind == "global":
        need = abs(n - m) + 1
        return need <= W - 16 and (W - need) // 2 >= _MIN_SLACK
    # extend: caller caps n <= m + EXT_MARGIN; long extensions
    # accumulate drift, keep them on the wide band
    return (n - m <= W // 2 - 8) and (W == 256 or m <= 256)


# Fixed chunk size per bucket (device path): every chunk has ONE static
# shape per bucket, so the whole pipeline compiles a closed set of
# signatures, one per bucket. The sizes bound the direction bytes a
# chunk holds on the device (B * M * W, one byte per DP cell) to
# 64-160 MiB.
CHUNK_BY_M = {(128, 128): 4096, (128, 256): 4096, (256, 128): 4096,
              (256, 256): 2048, (512, 128): 2048, (512, 256): 1024,
              (1024, 256): 512, (2048, 256): 256, (5120, 256): 128}

# Extra target bases given to end extensions beyond the query length;
# must stay below min(W)//2 - 8 so the band reaches the last DP row.
EXT_MARGIN = 48

_EMPTY_CIGAR = np.empty(0, np.uint32)


def _run(op: int, ln: int) -> np.ndarray:
    return np.array([(ln << 4) | op], np.uint32)


# ------------------------------------------------------ chunk scheduling
#
# Two production-scale mechanisms:
#
# 1. Decode pool: each dispatched chunk's collect (D2H sync + native
#    compact decode + rare host recompute) runs on a small shared
#    thread pool instead of the dispatching thread, so chunks are
#    collected in COMPLETION order and decode overlaps both device
#    work and other chunks' transfers (the native decoder and numpy
#    drop the GIL; native buffers are thread-local).
#
# 2. In-flight device-memory budget: each launched chunk holds
#    workspace on device (dirs arrays etc., ~ B*M*W bytes) from
#    dispatch until its collect drains it. At whole-genome scale the
#    resident index/ref plus several pipelined batches x all their
#    chunks can exceed device memory; instead of a scale-dependent
#    batch-size constant, dispatch blocks while estimated in-flight
#    workspace would exceed the budget the Aligner computes from
#    device memory minus resident bytes. Deadlock-free: waiters are
#    dispatchers, releasers are collectors of already-dispatched chunks
#    (collects never wait on the budget), and the first chunk is always
#    admitted.

_COLLECT_WORKERS = 4


def _chunk_inflight_bytes(M: int, W: int) -> int:
    """Estimated per-chunk device workspace held between dispatch and
    collect: the direction storage dominates (1 byte/cell), plus
    window/state intermediates."""
    B = CHUNK_BY_M[(M, W)]
    return B * M * W + (32 << 20)


class _InflightLimiter:
    def __init__(self):
        self._cond = threading.Condition()
        self._out = 0

    def acquire(self, nbytes: int, budget: int):
        with self._cond:
            while self._out > 0 and self._out + nbytes > budget:
                self._cond.wait()
            self._out += nbytes

    def release(self, nbytes: int):
        with self._cond:
            self._out -= nbytes
            self._cond.notify_all()


_LIMITER = _InflightLimiter()
_POOL = None
_POOL_LOCK = threading.Lock()


def _collect_pool():
    global _POOL
    if _POOL is None:
        with _POOL_LOCK:
            if _POOL is None:
                _POOL = concurrent.futures.ThreadPoolExecutor(
                    _COLLECT_WORKERS, thread_name_prefix="dp-collect")
    return _POOL


@dataclasses.dataclass
class DpResult:
    score: int
    cigar: np.ndarray           # packed uint32 runs ((len << 4) | op)
    q_used: int                 # query chars consumed
    t_used: int                 # target chars consumed


class DpBatcher:
    """Collect global/extend DP instances, run them bucketed, hand back
    per-instance results by handle. The engine (XLA DP + host traceback
    on the CPU, the fused device chain on the GPU) is picked by
    lamsa_tpu/device.py; pass `kernel` only to force a specific
    XLA-contract kernel (tests).

    device_sources — (flat_read_codes_dev, ref_codes_dev) device arrays
    — switches the device engine to device-side window assembly: the
    enqueue calls then also carry (qd, td) descriptors (see
    ops/banded_sw.py::_dp_tb_fused_gather) and each chunk uploads 4
    int32 per instance instead of M + (M+W) codes."""

    def __init__(self, scores, kernel=None, device_sources=None,
                 min_band: int = 0, mesh=None, host_sources=None,
                 inflight_budget: int | None = None):
        self.scores = scores
        self.kernel = kernel
        self.device_sources = device_sources
        # inflight_budget — device bytes chunks may hold between
        # dispatch and collect (None = unlimited; see chunk-scheduling
        # note above). Shared across concurrent batchers (_LIMITER is
        # module-global: pipelined batches share one device).
        self.inflight_budget = inflight_budget
        # host_sources — (flat_read_codes, ref_codes) HOST arrays
        # mirroring device_sources: descriptor-only instances (the bulk
        # enqueue path) materialize their q/t content from these when a
        # rare host recompute is needed (compact-event overflow,
        # no-bucket fallback, or the XLA engine in tests)
        self.host_sources = host_sources
        # mesh: data-parallel jax.sharding.Mesh — DP chunks shard their
        # instance dim across it (parallel/mesh.py read-level DP)
        self.mesh = mesh
        # min_band: the CLI -w knob — instances route only to buckets
        # with W >= min_band (config.AlignConfig.band_width)
        self.buckets = tuple(b for b in BUCKETS if b[1] >= min_band) \
            or BUCKETS[-1:]
        self._inst: list[dict] = []
        self._results: list[DpResult | None] = []
        # descriptor-only instances, stored columnar (the production
        # device-gather path: per-instance Python dicts were ~1/3 of
        # the host time at the 10 kb working point)
        self._bulk: list[dict] = []       # record batches of np columns
        self._scal: dict | None = None    # per-column lists (scalar adds)

    def _shard(self, *arrays):
        """Place arrays with the leading dim sharded over the mesh."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from lamsa_tpu.parallel.mesh import DATA_AXIS
        out = [jax.device_put(
            a, NamedSharding(self.mesh, P(DATA_AXIS,
                                          *([None] * (a.ndim - 1)))))
            for a in arrays]
        return tuple(out)

    # ------------------------------------------------------------ enqueue

    def add_global(self, q: np.ndarray, t: np.ndarray, qd=None,
                   td=None, minw: int = 0) -> int:
        """Global alignment of q vs t (both fully consumed). minw:
        minimum band width this instance may route to (coalesced spans
        whose interior drift needs the wide band pass 256)."""
        idx = len(self._results)
        if len(q) == 0 and len(t) == 0:
            self._results.append(DpResult(0, _EMPTY_CIGAR, 0, 0))
        elif len(q) == 0:
            s = -(self.scores.gap_open + len(t) * self.scores.gap_ext)
            self._results.append(DpResult(s, _run(OP_D, len(t)), 0, len(t)))
        elif len(t) == 0:
            s = -(self.scores.gap_open + len(q) * self.scores.gap_ext)
            self._results.append(DpResult(s, _run(OP_I, len(q)), len(q), 0))
        else:
            self._results.append(None)
            self._inst.append({"idx": idx, "kind": "global",
                               "q": np.asarray(q, np.uint8),
                               "t": np.asarray(t, np.uint8),
                               "qd": qd, "td": td, "minw": minw})
        return idx

    def add_extend(self, q: np.ndarray, t: np.ndarray,
                   to_end_bonus: int, qd=None, td=None) -> int:
        """Extension from (0,0) into q/t; soft-clip decision applied:
        result consumes all of q iff to_end >= best - to_end_bonus."""
        idx = len(self._results)
        if len(q) == 0 or len(t) == 0:
            # nothing to extend into (empty query, or anchor at ref edge)
            self._results.append(DpResult(0, _EMPTY_CIGAR, 0, 0))
        else:
            self._results.append(None)
            self._inst.append({"idx": idx, "kind": "extend",
                               "q": np.asarray(q, np.uint8),
                               "t": np.asarray(t, np.uint8),
                               "bonus": to_end_bonus,
                               "qd": qd, "td": td})
        return idx

    # ------------------------------------------- descriptor-only enqueue

    _COLS = ("idx", "m", "n", "qb", "qs", "qc", "tb", "ts", "glob",
             "bonus", "minw")

    def _trivial(self, h0, m, n, kind):
        """Resolve zero-length instances immediately (same rules as the
        content enqueue paths). Returns bool[K] mask of trivia."""
        triv = (m == 0) | (n == 0)
        if triv.any():
            gapo, gape = self.scores.gap_open, self.scores.gap_ext
            for i in np.flatnonzero(triv):
                mi, ni = int(m[i]), int(n[i])
                if kind == "extend" or (mi == 0 and ni == 0):
                    self._results[h0 + i] = DpResult(0, _EMPTY_CIGAR, 0, 0)
                elif mi == 0:
                    self._results[h0 + i] = DpResult(
                        -(gapo + ni * gape), _run(OP_D, ni), 0, ni)
                else:
                    self._results[h0 + i] = DpResult(
                        -(gapo + mi * gape), _run(OP_I, mi), mi, 0)
        return triv

    def add_globals_bulk(self, m, n, q_base, q_step, q_comp,
                         t_base, minw=None) -> int:
        """Vectorized enqueue of K global gap instances described by
        device-gather descriptors (see _dp_tb_fused_gather); content is
        never materialized on the happy path. minw: optional per-
        instance minimum band width (see add_global). Returns the first
        handle; instance i gets handle first + i."""
        h0 = len(self._results)
        K = len(m)
        self._results.extend([None] * K)
        m = np.asarray(m, np.int64)
        n = np.asarray(n, np.int64)
        keep = ~self._trivial(h0, m, n, "global")
        if keep.any():
            ki = np.flatnonzero(keep)
            self._bulk.append({
                "idx": h0 + ki,
                "m": m[ki], "n": n[ki],
                "qb": np.asarray(q_base, np.int64)[ki],
                "qs": np.broadcast_to(np.asarray(q_step, np.int64),
                                      (K,))[ki],
                "qc": np.broadcast_to(np.asarray(q_comp, np.int64),
                                      (K,))[ki],
                "tb": np.asarray(t_base, np.int64)[ki],
                "ts": np.ones(len(ki), np.int64),
                "glob": np.ones(len(ki), bool),
                "bonus": np.zeros(len(ki), np.int64),
                "minw": (np.zeros(len(ki), np.int64) if minw is None
                         else np.asarray(minw, np.int64)[ki]),
            })
        return h0

    def _add_desc_scalar(self, kind, m, n, qd, td, bonus) -> int:
        h0 = len(self._results)
        self._results.append(None)
        if self._trivial(h0, np.array([m]), np.array([n]), kind)[0]:
            return h0
        if self._scal is None:
            self._scal = {c: [] for c in self._COLS}
        s = self._scal
        s["idx"].append(h0)
        s["m"].append(m)
        s["n"].append(n)
        s["qb"].append(qd[0])
        s["qs"].append(qd[1])
        s["qc"].append(qd[2])
        s["tb"].append(td[0])
        s["ts"].append(td[1])
        s["glob"].append(kind == "global")
        s["bonus"].append(bonus)
        s["minw"].append(0)
        return h0

    def add_global_desc(self, m: int, n: int, qd, td) -> int:
        return self._add_desc_scalar("global", m, n, qd, td, 0)

    def add_extend_desc(self, m: int, n: int, to_end_bonus: int, qd,
                        td) -> int:
        return self._add_desc_scalar("extend", m, n, qd, td,
                                     to_end_bonus)

    def _materialize(self, c, i):
        """q/t content of columnar instance i (host fallback paths)."""
        flat, refc = self.host_sources
        m, n = int(c["m"][i]), int(c["n"][i])
        y = int(c["qb"][i]) + int(c["qs"][i]) * np.arange(m)
        q = flat[y].astype(np.uint8)
        if int(c["qc"][i]):
            q = np.where(q < 4, 3 - q, q).astype(np.uint8)
        x = int(c["tb"][i]) + int(c["ts"][i]) * np.arange(n)
        t = np.asarray(refc[x], np.uint8)
        return q, t

    # ---------------------------------------------------------------- run

    def _merged_cols(self) -> dict | None:
        """Concatenate the columnar record batches (+ scalar adds) into
        one dict of np arrays; clears the stores."""
        batches = list(self._bulk)
        if self._scal is not None:
            batches.append({k: np.asarray(v, np.int64)
                            for k, v in self._scal.items()})
        self._bulk = []
        self._scal = None
        if not batches:
            return None
        return {k: np.concatenate([b[k] for b in batches])
                for k in self._COLS}

    def _launch(self, dispatch, M, W, futs):
        """Dispatch one chunk under the in-flight memory budget and hand
        its collect to the decode pool (chunk-scheduling note above)."""
        est = _chunk_inflight_bytes(M, W)
        if self.mesh is not None:
            est //= self.mesh.devices.size
        bud = self.inflight_budget
        if bud:
            _LIMITER.acquire(est, bud)
        try:
            lch = dispatch()
        except BaseException:
            if bud:
                _LIMITER.release(est)
            raise
        futs.append(_collect_pool().submit(
            self._collect_one, lch, est if bud else 0))

    def _collect_one(self, lch, rel_bytes):
        try:
            insts, M, W, dev = lch
            try:
                dev.copy_to_host_async()
            except AttributeError:
                pass
            self._collect_device(insts, M, W, dev)
        finally:
            if rel_bytes:
                _LIMITER.release(rel_bytes)

    def run(self) -> None:
        from lamsa_tpu.device import use_device_path
        on_dev = self.kernel is None and use_device_path()
        use_gather = on_dev and self.device_sources is not None
        futs = []

        # ---- columnar (descriptor) instances: vectorized bucketing
        c = self._merged_cols()
        if c is not None:
            m, n, glob = c["m"], c["n"], c["glob"]
            need = np.abs(n - m) + 1
            bid = np.full(len(m), -1, np.int64)
            for bi, (M, W) in enumerate(self.buckets):
                fit_g = (m <= M) & (need <= W - 16) \
                    & ((W - need) // 2 >= _MIN_SLACK) & (W >= c["minw"])
                fit_e = (m <= M) & (n - m <= W // 2 - 8) \
                    & ((W == 256) | (m <= 256))
                fit = np.where(glob, fit_g, fit_e)
                bid = np.where((bid < 0) & fit, bi, bid)
            nofit = np.flatnonzero(bid < 0)
            if len(nofit):                      # pathological fallback
                from lamsa_tpu.utils.timers import GLOBAL as STATS
                STATS.count("dp_no_bucket_fallback", len(nofit))
            for i in nofit:
                mi, ni = int(m[i]), int(n[i])
                s = -(2 * self.scores.gap_open
                      + (mi + ni) * self.scores.gap_ext)
                self._results[int(c["idx"][i])] = DpResult(
                    s, np.concatenate([_run(OP_I, mi), _run(OP_D, ni)]),
                    mi, ni)
            for bi, (M, W) in enumerate(self.buckets):
                sel = np.flatnonzero(bid == bi)
                if len(sel) == 0:
                    continue
                sel = sel[np.argsort(-m[sel], kind="stable")]
                chunk = CHUNK_BY_M[(M, W)]
                for c0 in range(0, len(sel), chunk):
                    sl = {k: v[sel[c0:c0 + chunk]] for k, v in c.items()}
                    if use_gather:
                        self._launch(
                            lambda sl=sl: self._dispatch_cols(sl, M, W),
                            M, W, futs)
                    else:
                        self._run_cols_host(sl, M, W)

        # ---- explicit (content) instances: per-instance path
        groups: dict[tuple, list] = {}
        for inst in self._inst:
            m_, n_ = len(inst["q"]), len(inst["t"])
            for M, W in self.buckets:
                if _bucket_fits(inst["kind"], m_, n_, M, W,
                                inst.get("minw", 0)):
                    key = (M, W)
                    break
            else:
                # no bucket fits (pathological gap) — crude fallback
                from lamsa_tpu.utils.timers import GLOBAL as STATS
                STATS.count("dp_no_bucket_fallback", 1)
                s = -(2 * self.scores.gap_open
                      + (m_ + n_) * self.scores.gap_ext)
                self._results[inst["idx"]] = DpResult(
                    s, np.concatenate([_run(OP_I, m_), _run(OP_D, n_)]),
                    m_, n_)
                continue
            groups.setdefault(key, []).append(inst)
        self._inst = []
        # Instances run sorted by query length. On the device path ALL
        # chunks are dispatched asynchronously before any is collected,
        # overlapping device work with host<->device round trips.
        for (M, W), insts in sorted(groups.items()):
            insts.sort(key=lambda it: -len(it["q"]))
            chunk = CHUNK_BY_M[(M, W)]
            for c0 in range(0, len(insts), chunk):
                part = insts[c0:c0 + chunk]
                if on_dev:
                    self._launch(
                        lambda part=part: self._dispatch_device(part, M, W),
                        M, W, futs)
                else:
                    self._run_group_host(part, M, W)
        for f in futs:          # all collects ran on the decode pool;
            f.result()          # propagate any worker exception

    def _build_arrays(self, insts, M, W, Bp):
        # uint8 codes (cast to int32 on the device): a quarter of the
        # host->device bytes
        q = np.zeros((Bp, M), np.uint8)
        t_win = np.zeros((Bp, M + W), np.uint8)
        m_len = np.zeros(Bp, np.int32)
        n_len = np.zeros(Bp, np.int32)
        lo = np.zeros(Bp, np.int32)
        is_global = np.zeros(Bp, bool)
        bonus = np.zeros(Bp, np.int32)
        from lamsa_tpu.ops.banded_sw import global_lo
        for b, inst in enumerate(insts):
            qq, tt = inst["q"], inst["t"]
            m, n = len(qq), len(tt)
            m_len[b], n_len[b] = m, n
            if inst["kind"] == "global":
                lo[b] = global_lo(m, n, W)
                is_global[b] = True
            else:
                # extend callers cap n <= m + EXT_MARGIN < W//2, so the
                # centered band always reaches the last row
                lo[b] = -(W // 2)
                bonus[b] = inst["bonus"]
            q[b, :m] = qq
            t_win[b] = make_t_window(tt, int(lo[b]), M, W)
        return q, t_win, m_len, n_len, lo, is_global, bonus

    # ------------------------------------------------------- device engine

    def _dispatch_device(self, insts, M, W):
        from lamsa_tpu.ops.banded_sw import (dispatch_group,
                                             dispatch_group_gather)
        from lamsa_tpu.utils.timers import GLOBAL as STATS
        Bp = CHUNK_BY_M[(M, W)]   # one static shape per bucket
        gather = (self.device_sources is not None
                  and all(i["qd"] is not None for i in insts))
        with STATS.stage(f"dp_build_{M}x{W}"):
            if gather:
                desc = self._build_desc(insts, M, W, Bp)
            else:
                arrays = self._build_arrays(insts, M, W, Bp)
        STATS.count(f"dp_cells_{M}x{W}",
                    sum(len(i["q"]) for i in insts) * W)
        STATS.count("dp_instances", len(insts))
        with STATS.stage(f"dp_dispatch_{M}x{W}"):
            if gather:
                if self.mesh is not None:
                    (desc,) = self._shard(desc)
                flat_dev, ref_dev = self.device_sources
                dev = dispatch_group_gather(desc, flat_dev, ref_dev,
                                            self.scores, M, W,
                                            mesh=self.mesh)
            else:
                arrays = self._shard(*arrays) if self.mesh is not None \
                    else arrays
                dev = dispatch_group(*arrays, self.scores, mesh=self.mesh)
        return insts, M, W, dev

    def _build_desc(self, insts, M, W, Bp):
        """Packed (Bp, 4) descriptor array for the device-gather
        dispatch (ops/banded_sw.py pack_desc wire format) from explicit
        per-instance dicts."""
        from lamsa_tpu.ops.banded_sw import _LO_BIAS, pack_desc
        K = len(insts)
        cols = {c: np.zeros(K, np.int64) for c in
                ("qb", "qs", "qc", "tb", "ts", "m", "n", "lo", "bonus")}
        glob = np.zeros(K, bool)
        for b, inst in enumerate(insts):
            m, n = len(inst["q"]), len(inst["t"])
            qb, qs, qc = inst["qd"]
            tb, ts = inst["td"]
            cols["qb"][b], cols["qs"][b], cols["qc"][b] = qb, qs, qc
            cols["tb"][b], cols["ts"][b] = tb, ts
            cols["m"][b], cols["n"][b] = m, n
            if inst["kind"] == "global":
                from lamsa_tpu.ops.banded_sw import global_lo
                cols["lo"][b] = global_lo(m, n, W)
                glob[b] = True
            else:
                cols["lo"][b] = -(W // 2)
                cols["bonus"][b] = inst["bonus"]
        desc = np.zeros((Bp, 4), np.int32)
        desc[K:, 3] = _LO_BIAS            # padding rows decode to lo=0
        desc[:K] = pack_desc(cols["qb"], cols["qs"], cols["qc"],
                             cols["tb"], cols["ts"], cols["m"], cols["n"],
                             cols["lo"], glob, cols["bonus"])
        return desc

    @staticmethod
    def _cols_lo(sl, W):
        from lamsa_tpu.ops.banded_sw import global_lo
        return np.where(sl["glob"], global_lo(sl["m"], sl["n"], W),
                        -(W // 2)).astype(np.int64)

    def _dispatch_cols(self, sl, M, W):
        """Columnar twin of _dispatch_device: descriptor slices pack
        straight into the (Bp, 4) wire array (no per-instance dicts)."""
        from lamsa_tpu.ops.banded_sw import (_LO_BIAS, dispatch_group_gather,
                                             pack_desc)
        from lamsa_tpu.utils.timers import GLOBAL as STATS
        Bp = CHUNK_BY_M[(M, W)]
        K = len(sl["m"])
        with STATS.stage(f"dp_build_{M}x{W}"):
            sl = dict(sl)
            sl["lo"] = self._cols_lo(sl, W)
            desc = np.zeros((Bp, 4), np.int32)
            desc[K:, 3] = _LO_BIAS        # padding rows decode to lo=0
            desc[:K] = pack_desc(sl["qb"], sl["qs"], sl["qc"], sl["tb"],
                                 sl["ts"], sl["m"], sl["n"], sl["lo"],
                                 sl["glob"], sl["bonus"])
        STATS.count(f"dp_cells_{M}x{W}", int(sl["m"].sum()) * W)
        STATS.count("dp_instances", K)
        with STATS.stage(f"dp_dispatch_{M}x{W}"):
            if self.mesh is not None:
                (desc,) = self._shard(desc)
            flat_dev, ref_dev = self.device_sources
            dev = dispatch_group_gather(desc, flat_dev, ref_dev, self.scores,
                                        M, W, mesh=self.mesh)
        return sl, M, W, dev

    def _run_cols_host(self, sl, M, W):
        """Columnar instances on the host (XLA) engine: materialize
        content from host_sources, reuse the explicit group path."""
        glob = sl["glob"]
        insts = []
        for i in range(len(sl["m"])):
            q, t = self._materialize(sl, i)
            insts.append({"idx": int(sl["idx"][i]),
                          "kind": "global" if glob[i] else "extend",
                          "q": q, "t": t, "bonus": int(sl["bonus"][i]),
                          "qd": None, "td": None})
        self._run_group_host(insts, M, W)

    def _collect_device(self, insts, M, W, dev):
        from lamsa_tpu import native
        from lamsa_tpu.ops.banded_sw import collect_group
        from lamsa_tpu.utils.timers import GLOBAL as STATS
        with STATS.stage(f"dp_collect_{M}x{W}"):
            cigars, score, si, sd = collect_group(dev, M)
        if isinstance(insts, dict):            # columnar launch
            sl = insts
            K = len(sl["idx"])
            # bulk-convert device/np scalars once (tolist() is C-level;
            # per-element int() on np scalars was ~0.4 ms/read of the
            # 10 kb host wall)
            idxs = sl["idx"].tolist()
            los = sl["lo"].tolist()
            i_l = si[:K].tolist()
            j_l = (si[:K] + sl["lo"] + sd[:K]).tolist()
            sc_l = score[:K].tolist()
            res = self._results
            for b in range(K):
                cig = cigars[b]
                if cig is None:
                    q, t = self._materialize(sl, b)
                    cig = native.banded_sw_tb(q, t, self.scores, los[b],
                                              los[b] + W - 1, i_l[b],
                                              j_l[b])
                res[idxs[b]] = DpResult(sc_l[b], cig, i_l[b], j_l[b])
            return
        from lamsa_tpu.ops.banded_sw import global_lo
        for b, inst in enumerate(insts):
            m, n = len(inst["q"]), len(inst["t"])
            if inst["kind"] == "global":
                lo_b = int(global_lo(m, n, W))
            else:
                lo_b = -(W // 2)
            i = int(si[b])
            j = i + lo_b + int(sd[b])
            cig = cigars[b]
            if cig is None:
                # compact event budget overflowed on device (rare:
                # > E deletions in one gap) — recompute this instance
                # bit-identically on the host
                cig = native.banded_sw_tb(inst["q"], inst["t"],
                                          self.scores, lo_b,
                                          lo_b + W - 1, i, j)
            self._results[inst["idx"]] = DpResult(int(score[b]), cig, i, j)

    # --------------------------------------------------- host (XLA) engine

    def _run_group_host(self, insts, M, W):
        from lamsa_tpu.ops.banded_sw import run_group_xla
        B = len(insts)
        Bp = max(8, 1 << (B - 1).bit_length())
        if self.mesh is not None:
            n = self.mesh.devices.size
            Bp = -(-Bp // n) * n
        q, t_win, m_len, n_len, lo, is_global, bonus = \
            self._build_arrays(insts, M, W, Bp)

        from lamsa_tpu.utils.timers import GLOBAL as STATS
        STATS.count(f"dp_cells_{M}x{W}", int(m_len.sum()) * W)
        STATS.count("dp_instances", B)
        if self.kernel is not None:
            out, cigar = self._run_explicit(q, t_win, m_len, n_len, lo)
        else:
            zdrop = np.where(is_global, 0,
                             np.int32(self.scores.zdrop)).astype(np.int32)
            args = (q, t_win, m_len, n_len, lo, zdrop)
            if self.mesh is not None:
                # XLA engine under a mesh: shard the instance dim; the
                # row scan partitions along it with no collectives
                args = self._shard(*args)
            out, cigar = run_group_xla(*args[:5], self.scores, args[5])

        best = out["best"]
        for b, inst in enumerate(insts):
            m, n, lo_b = int(m_len[b]), int(n_len[b]), int(lo[b])
            if inst["kind"] == "global":
                i, j, sc = m, n, int(out["global_score"][b])
            else:
                b_score, b_i, b_d = (int(best[b, 0]), int(best[b, 1]),
                                     int(best[b, 2]))
                te_score = int(out["te_score"][b])
                te_j = m + lo_b + int(out["te_d"][b])
                if te_score > -29000 and te_score >= b_score - inst["bonus"]:
                    i, j, sc = m, te_j, te_score
                else:
                    i, j, sc = b_i, b_i + lo_b + b_d, b_score
            self._results[inst["idx"]] = DpResult(sc, cigar(b, i, j), i, j)

    def _run_explicit(self, q, t_win, m_len, n_len, lo):
        """Test hook: run a caller-provided kernel with the XLA-style
        contract (uint8 dirs) and host traceback."""
        sc = self.scores
        res = self.kernel(q.astype(np.int32), t_win.astype(np.int32),
                          m_len, n_len, lo,
                          match=sc.match, mismatch=sc.mismatch,
                          gapo=sc.gap_open, gape=sc.gap_ext)
        from lamsa_tpu.ops.banded_sw import extract_scores
        g, te, te_d = extract_scores(res["h_last"], m_len, n_len, lo)
        dirs = np.asarray(res["dirs"])
        out = {"global_score": np.asarray(g), "te_score": np.asarray(te),
               "te_d": np.asarray(te_d), "best": np.asarray(res["best"])}

        def cigar(b, i, j):
            from lamsa_tpu.native import cigar_to_runs
            return cigar_to_runs(traceback_banded(dirs[b], int(lo[b]),
                                                  i, j))

        return out, cigar

    def result(self, idx: int) -> DpResult:
        r = self._results[idx]
        assert r is not None, "DpBatcher.run() not called or instance lost"
        return r


def compute_nm(q: np.ndarray, t: np.ndarray, cigar) -> int:
    """Edit distance (NM tag) from a stitched CIGAR: mismatches inside
    M runs plus inserted/deleted bases."""
    nm = 0
    i = j = 0
    for op, ln in cigar_pairs(cigar):
        if op == OP_M:
            qs = q[i:i + ln]
            ts = t[j:j + ln]
            nm += int(np.sum((qs != ts) | (qs >= 4) | (ts >= 4)))
            i += ln
            j += ln
        elif op == OP_I:
            nm += ln
            i += ln
        elif op == OP_D:
            nm += ln
            j += ln
        else:  # soft clips consume query only, no edits
            i += ln
    return nm


def md_tag(q: np.ndarray, t: np.ndarray, cigar) -> str:
    """SAM MD:Z tag from the clip-less CIGAR and aligned code windows
    (q = query window, t = reference window). Matches samtools calmd
    semantics: match-run lengths, mismatch ref bases, ^-prefixed
    deletion runs; insertions are invisible to MD."""
    from lamsa_tpu.io.fasta import BASES
    out = []
    run = 0
    i = j = 0
    for op, ln in cigar_pairs(cigar):
        if op == OP_M:
            qs, ts = q[i:i + ln], t[j:j + ln]
            mismatch = (qs != ts) | (qs >= 4) | (ts >= 4)
            for x in range(ln):
                if mismatch[x]:
                    out.append(str(run))
                    run = 0
                    out.append(BASES[int(ts[x])])
                else:
                    run += 1
            i += ln
            j += ln
        elif op == OP_I:
            i += ln
        elif op == OP_D:
            out.append(str(run))
            run = 0
            out.append("^" + "".join(BASES[int(c)] for c in t[j:j + ln]))
            j += ln
        else:
            i += ln
    out.append(str(run))
    return "".join(out)
