"""End-to-end alignment pipeline (the aln orchestrator).

Accelerator-native equivalent of the reference's ``lamsa_aln`` driver
(SURVEY.md sections 2 L2 and 3.2): batches of reads flow through

  device:  seeding (pipeline/seeding.py)  ->  chaining (ops/chain.py)
  host:    skeleton assembly + SV classification (pipeline/skeleton.py)
  device:  bucketed banded-DP gap fill + end extension (pipeline/extend.py)
  host:    CIGAR stitching, MAPQ, primary/supplementary selection,
           SA:Z linking, SAM records (io/sam.py)

Where the reference used a pthread pool over reads, parallelism here is
the batch dimension of the device kernels (and, across chips, data
parallelism over read shards — parallel/).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from lamsa_tpu.config import AlignConfig
from lamsa_tpu.index.kmer import KmerIndex
from lamsa_tpu.io.fasta import encode_seq
from lamsa_tpu.io.refpack import PackedReference
from lamsa_tpu.io.sam import (FLAG_REVERSE, FLAG_SUPPLEMENTARY, OP_M, OP_S,
                              SamRecord, merge_runs, unmapped_record)
from lamsa_tpu.ops.chain import chain_hits
from lamsa_tpu.pipeline.extend import EXT_MARGIN, DpBatcher
from lamsa_tpu.pipeline.seeding import make_qpos_grid, seed_hits
from lamsa_tpu.pipeline.skeleton import anchors_to_blocks, build_skeleton
from lamsa_tpu.utils.timers import GLOBAL as STATS

_EXT_CAP = 2048          # longest end extension attempted (rest soft-clips)

# Hit packing uses 19 bits for qpos (pipeline/seeding._QPOS_BITS);
# longer reads would silently corrupt the strand/valid bits, so they
# are rejected as unmapped with a warning instead.
MAX_READ_LEN = 1 << 19

# Reverse-complement table for SAM SEQ strings; anything outside
# ACGTN maps to N (same behavior as the previous per-char dict lookup)
_RC_TRANS = {i: ord("N") for i in range(256)}
_RC_TRANS.update(str.maketrans("ACGTN", "TGCAN"))

# invalid-lane sentinel for the merge-rechain sort key
# ((strand << 51) | (qpos << 32) | rpos fits 52 bits)
_MERGE_INV = np.int64(1) << 62
# element budget for one adaptive-retry seeding sub-batch (the sorted
# key/row arrays, int32 each): bounds the retry's device footprint at
# whole-genome scale (see _seed_and_chain retry cap note)
_RETRY_BUDGET_ELEMS = 16_000_000


def _pack_hits_chain(hits, *, weight, lookback, max_dist, diag_slack):
    """Pack the per-read hit+chain arrays into 3 int32 planes for ONE
    compact device->host transfer:
      plane 0: rpos bit-pattern
      plane 1: qpos (19 bits) | strand << 19 | valid << 20
      plane 2: f (19 bits; f <= weight * max_hits << 2^19) | (pred+1) << 19
    Host decode in Aligner._seed_and_chain."""
    f, pred = chain_hits(hits["qpos"], hits["rpos"], hits["strand"],
                         hits["valid"], weight=weight, lookback=lookback,
                         max_dist=max_dist, diag_slack=diag_slack)
    return jnp.stack([
        jax.lax.bitcast_convert_type(hits["rpos"], jnp.int32),
        hits["qpos"] | (hits["strand"] << 19)
        | (hits["valid"].astype(jnp.int32) << 20),
        f | ((pred + 1) << 19),
    ])


@functools.partial(
    jax.jit,
    static_argnames=("k", "cands_per_seed", "max_hits", "weight", "lookback",
                     "max_dist", "diag_slack"))
def _seed_chain_packed(rc, lens, grid, keys, starts, counts, positions, *,
                       k, cands_per_seed, max_hits, weight, lookback,
                       max_dist, diag_slack):
    """Fused seeding+chaining returning one packed (3, B, H) int32 array
    (see _pack_hits_chain) — single compact transfer. rc may be uint8
    (1 byte/base upload); cast to the seeding contract on device."""
    hits = seed_hits(rc.astype(jnp.int32), lens, grid, keys, starts,
                     counts, positions, k=k,
                     cands_per_seed=cands_per_seed, max_hits=max_hits)
    return _pack_hits_chain(hits, weight=weight, lookback=lookback,
                            max_dist=max_dist, diag_slack=diag_slack)


@functools.partial(
    jax.jit,
    static_argnames=("k", "cands_per_seed", "max_hits", "weight", "lookback",
                     "max_dist", "diag_slack"))
def _seed_chain_packed_direct(rc, lens, grid, dense_starts, dense_counts,
                              positions, *, k, cands_per_seed, max_hits,
                              weight, lookback, max_dist, diag_slack):
    """Direct-address (dense 4^k table) variant — device path, k <= 13."""
    from lamsa_tpu.pipeline.seeding import seed_hits_direct
    hits = seed_hits_direct(rc.astype(jnp.int32), lens, grid, dense_starts,
                            dense_counts, positions, k=k,
                            cands_per_seed=cands_per_seed,
                            max_hits=max_hits)
    return _pack_hits_chain(hits, weight=weight, lookback=lookback,
                            max_dist=max_dist, diag_slack=diag_slack)


@functools.partial(
    jax.jit,
    static_argnames=("weight", "lookback", "max_dist", "diag_slack"))
def _chain_packed_only(qpos, rpos, strand, valid, *, weight, lookback,
                       max_dist, diag_slack):
    """Chain + pack for an already-assembled hit set (the adaptive
    union-merge path: host merges original + re-seeded hits, chaining
    re-runs on device)."""
    hits = {"qpos": jnp.asarray(qpos), "rpos": jnp.asarray(rpos),
            "strand": jnp.asarray(strand),
            "valid": jnp.asarray(valid)}
    return _pack_hits_chain(hits, weight=weight, lookback=lookback,
                            max_dist=max_dist, diag_slack=diag_slack)


@functools.partial(
    jax.jit,
    static_argnames=("k", "cands_per_seed", "max_hits", "weight", "lookback",
                     "max_dist", "diag_slack", "sa_rate", "seg_quota",
                     "sub1_cands", "sub1_k", "sub1_kinds"))
def _seed_chain_packed_fm(rc, lens, grid, fm_dev, *, k, cands_per_seed,
                          max_hits, weight, lookback, max_dist, diag_slack,
                          sa_rate, seg_quota=0, sub1_cands=0, sub1_k=0,
                          sub1_kinds="s"):
    """FM-index variant (whole-genome path). sub1_cands > 0 adds
    1-edit-tolerant piece search (adaptive re-seed only)."""
    from lamsa_tpu.pipeline.seeding import seed_hits_fm
    hits = seed_hits_fm(rc.astype(jnp.int32), lens, grid, fm_dev, k=k,
                        cands_per_seed=cands_per_seed, max_hits=max_hits,
                        sa_rate=sa_rate, seg_quota=seg_quota,
                        sub1_cands=sub1_cands, sub1_k=sub1_k,
                        sub1_kinds=sub1_kinds)
    return _pack_hits_chain(hits, weight=weight, lookback=lookback,
                            max_dist=max_dist, diag_slack=diag_slack)


def _trim_boundary_indels(merged, pos, qs_cov, qe_cov):
    """Canonicalize a stitched clip-less CIGAR's boundaries: alignments
    must start and end with M (samtools/hts-specs convention; the
    validator io/samcheck.py enforces it). Boundary I runs become soft
    clip (the covered query span shrinks); boundary D runs are dropped,
    a leading one advancing pos. Returns (runs, pos, qs_cov, qe_cov),
    runs=None if nothing alignable remains."""
    from lamsa_tpu.io.sam import OP_D, OP_I
    a, b = 0, len(merged)
    while a < b:
        op, ln = int(merged[a]) & 0xF, int(merged[a]) >> 4
        if op == OP_I:
            qs_cov += ln
        elif op == OP_D:
            pos += ln
        else:
            break
        a += 1
    while b > a:
        op, ln = int(merged[b - 1]) & 0xF, int(merged[b - 1]) >> 4
        if op == OP_I:
            qe_cov -= ln
        elif op != OP_D:
            break
        b -= 1
    if a == 0 and b == len(merged):
        return merged, pos, qs_cov, qe_cov
    out = merged[a:b]
    if not ((out & 0xF) == OP_M).any():
        return None, pos, qs_cov, qe_cov
    return out, pos, qs_cov, qe_cov


def _revcomp_codes(codes: np.ndarray) -> np.ndarray:
    from lamsa_tpu import native
    return native.revcomp4(codes)


@functools.partial(jax.jit, static_argnames=("L",))
def gather_rc(flatp, offs, lens, *, L):
    """Assemble the (B, L) padded read-code matrix ON DEVICE from the
    batch's resident packed flat code array (read b =
    codes[offs[b]:offs[b] + lens[b]], padded with 4) — the flat array
    is uploaded once per batch anyway for DP window gathers, so this
    removes the second (B, L) upload entirely. One word gather per
    read (8 codes/element,
    ops/banded_sw.py::gather_packed_run) instead of B*L element
    gathers. Bit-identical to the host-assembled matrix by
    construction (tests/test_gather_dispatch.py)."""
    from lamsa_tpu.ops.banded_sw import gather_packed_run
    i = jnp.arange(L, dtype=jnp.int32)[None, :]
    step = jnp.ones(offs.shape[0], jnp.int32)
    g = gather_packed_run(flatp, offs.astype(jnp.uint32), step, L) \
        .astype(jnp.uint8)
    return jnp.where(i < lens[:, None], g, jnp.uint8(4))


@dataclasses.dataclass
class _PendingPart:
    part: object
    blocks: np.ndarray
    gap_handles: list          # DP handles between blocks (or ("op", len))
    left_handle: int | None
    right_handle: int | None
    o_lo: int
    o_hi: int
    secondary: bool = False


class Aligner:
    """index: a KmerIndex (small/medium genomes) or FmIndex
    (whole-genome; ~2.3 GB of device memory for GRCh38 vs ~13 GB of
    position tables).

    mesh: optional jax.sharding.Mesh for read-level data parallelism
    (SURVEY.md section 5 distributed row): index/reference arrays are
    replicated per chip, every device stage — seeding gathers, chain
    scan, banded DP + traceback — shards its batch/instance dim, and
    host skeleton/finalize stay per-read. Output SAM is byte-identical
    to the single-device run (tests/test_parallel.py).

    Whether the device path runs (reference, index tables and batch
    reads resident on the device) is lamsa_tpu/device.py's decision,
    read once here."""

    def __init__(self, ref: PackedReference, index,
                 config: AlignConfig | None = None, mesh=None):
        from lamsa_tpu.device import use_device_path
        from lamsa_tpu.index.fmindex import FmIndex
        self.device_path = use_device_path()
        self.ref = ref
        self.index = index
        self.config = config or AlignConfig()
        self.mesh = mesh
        self._rep = None
        if mesh is not None:
            n = mesh.devices.size
            assert n & (n - 1) == 0, \
                f"mesh size {n} must be a power of two (chunk divisibility)"
            from jax.sharding import NamedSharding, PartitionSpec as P
            self._rep = NamedSharding(mesh, P())
        if isinstance(index, FmIndex):
            from lamsa_tpu.index.kmer import auto_kmer
            from lamsa_tpu.ops.fm import device_arrays
            self.seed_backend = "fm"
            # the FM index is k-agnostic: scale the backward-search
            # piece length with genome size (a random 13-mer occurs
            # ~46x in 3.1 Gb — it would flood max_hits_per_read with
            # noise; 16 restores ~1 expected random hit)
            self.k = max(self.config.kmer, auto_kmer(ref.total_len))
            self._dev = device_arrays(index)
        else:
            self.seed_backend = "kmer"
            self.k = index.k
            if self.device_path and self.k <= 13:
                # dense 4^k direct-address tables (2 x 256 MB at k=13):
                # one gather replaces the 23-step binary search.
                # The sorted keys/starts/counts and the flat positions
                # array are NOT uploaded — the direct path reads only
                # the dense tables + the 16-wide position records
                # (uploading both layouts doubled the position tables)
                dense_s = np.zeros(4 ** self.k, np.int32)
                dense_c = np.zeros(4 ** self.k, np.int32)
                dense_s[index.keys] = index.starts
                dense_c[index.keys] = index.counts
                from lamsa_tpu.pipeline.seeding import pack_positions16
                self._dev = {
                    "dense_starts": jnp.asarray(dense_s),
                    "dense_counts": jnp.asarray(dense_c),
                    "pos16": jnp.asarray(
                        pack_positions16(index.positions
                                         .astype(np.uint32))),
                }
            else:
                self._dev = {
                    "keys": jnp.asarray(index.keys),
                    "starts": jnp.asarray(index.starts),
                    "counts": jnp.asarray(index.counts),
                    "positions": jnp.asarray(
                        index.positions.astype(np.uint32)),
                }
        if self._rep is not None:
            # replicate the index tables once per chip (SURVEY.md
            # section 5: per-chip index replica; whole-genome FM fits)
            self._dev = {k: jax.device_put(v, self._rep)
                         for k, v in self._dev.items()}
        self._grids = {}
        # Device path: the reference codes live on device once, and
        # DP windows are gathered there (ops/banded_sw.py
        # _dp_tb_fused_gather) — per-chunk uploads shrink to 4 int32
        # per instance.
        from lamsa_tpu.ops.banded_sw import pack_ref_device
        self._ref_dev = None
        self._inflight_budget = None
        if self.device_path:
            # packed int32 nibble words — word indices stay int32-safe
            # to the 4 Gb uint32 ceiling (ops/banded_sw.py layout note)
            self._ref_dev = pack_ref_device(ref.codes, self._rep)
            self._inflight_budget = self._compute_inflight_budget()

    def _compute_inflight_budget(self) -> int:
        """Device-byte budget for in-flight DP chunk workspace (see the
        chunk-scheduling note in pipeline/extend.py): a fraction of
        device memory minus the resident index/ref arrays, so chunk
        dispatch throttles itself at whole-genome scale instead of
        pushing the allocator into churn. Overridable for tuning via
        LAMSA_INFLIGHT_BUDGET (bytes) / LAMSA_INFLIGHT_FRACTION. A
        device that reports no memory limit is an error."""
        import os
        env = os.environ.get("LAMSA_INFLIGHT_BUDGET")
        if env:
            return int(float(env))
        dev = jax.local_devices()[0]
        limit = int((dev.memory_stats() or {}).get("bytes_limit", 0))
        if not limit:
            raise RuntimeError(
                f"{dev.device_kind} reports no bytes_limit in "
                f"memory_stats(); set LAMSA_INFLIGHT_BUDGET (bytes)")
        resident = int(self._ref_dev.nbytes) if self._ref_dev is not None \
            else 0
        for a in self._dev.values():
            resident += int(getattr(a, "nbytes", 0))
        frac = float(os.environ.get("LAMSA_INFLIGHT_FRACTION", "0.6"))
        return max(int(max(limit - resident, 0) * frac), 256 << 20)

    # ------------------------------------------------------------- batching

    def _bucket_len(self, n: int) -> int:
        for b in self.config.read_len_buckets:
            if n <= b:
                return b
        return int(2 ** math.ceil(math.log2(n)))

    def align_batch(self, reads) -> list[list[SamRecord]]:
        """Align a list of FastxRecords; returns SAM records per read,
        in input order."""
        cfg = self.config
        out: list[list[SamRecord] | None] = [None] * len(reads)
        codes = [np.frombuffer(encode_seq(r.seq), np.uint8) for r in reads]

        groups: dict[int, list[int]] = {}
        for i, c in enumerate(codes):
            if len(c) > MAX_READ_LEN:
                import warnings
                warnings.warn(
                    f"read {reads[i].name!r} is {len(c)} bp, beyond the "
                    f"{MAX_READ_LEN} bp qpos-packing limit; reported "
                    f"unmapped", stacklevel=2)
                out[i] = [unmapped_record(reads[i].name, reads[i].seq,
                                          reads[i].qual)]
                codes[i] = np.empty(0, np.uint8)   # keep flat pack small
                continue
            groups.setdefault(self._bucket_len(max(len(c), cfg.kmer + 1)),
                              []).append(i)

        flat_offs = None
        device_sources = None
        host_sources = None
        if self._ref_dev is not None:
            # flat forward read codes, device-resident for the batch;
            # padded to a power of two to keep the jit signature set
            # closed. Uploaded 4-bit packed into int32 words (8
            # codes/word — codes are 0..4): the flat upload is the
            # batch's largest single transfer, and device gathers fetch
            # whole words (ops/banded_sw.py gather_packed_run).
            total = sum(len(c) for c in codes)
            cap = max(1024, 1 << max(0, (total - 1)).bit_length())
            # MONOTONIC cap: a ragged tail batch (stream length not a
            # multiple of batch_reads) would otherwise shrink the flat
            # array and recompile EVERY DP-bucket signature (flat_dev
            # feeds each chunk dispatch) inside the run. Padding is
            # pure upload slack; results are sliced per read.
            cap = self._flat_cap = max(cap, getattr(self, "_flat_cap", 0))
            flat = np.full(cap, 4, np.uint8)
            flat_offs = np.zeros(len(codes) + 1, np.int64)
            pos = 0
            for i, c in enumerate(codes):
                flat_offs[i] = pos
                flat[pos:pos + len(c)] = c
                pos += len(c)
            flat_offs[-1] = pos
            from lamsa_tpu.ops.banded_sw import pack_codes_words
            device_sources = (jax.device_put(pack_codes_words(flat),
                                             self._rep),
                              self._ref_dev)
            host_sources = (flat, self.ref.codes)

        batcher = DpBatcher(cfg.scores, device_sources=device_sources,
                            min_band=cfg.band_width, mesh=self.mesh,
                            host_sources=host_sources,
                            inflight_budget=self._inflight_budget)
        pending: list[tuple[int, list[_PendingPart], object]] = []

        flat_dev = device_sources[0] if device_sources is not None else None
        for L, idxs in sorted(groups.items()):
            with STATS.stage("seed_chain_device"):
                hit_arrays = self._seed_and_chain(codes, idxs, L,
                                                  flat_dev=flat_dev,
                                                  flat_offs=flat_offs)
            with STATS.stage("skeleton_host"):
                for gi, ri in enumerate(idxs):
                    sk = self._build_skeleton(hit_arrays, gi, len(codes[ri]))
                    off = int(flat_offs[ri]) if flat_offs is not None \
                        else None
                    parts = self._enqueue_parts(sk, codes[ri], batcher,
                                                flat_off=off)
                    pending.append((ri, parts, sk))

        with STATS.stage("dp_batch"):
            batcher.run()

        with STATS.stage("finalize_host"):
            if cfg.threads > 1:
                # host worker pool over reads — the reference's pthread
                # model (SURVEY.md section 2b); ctypes/numpy calls drop
                # the GIL so finalize overlaps across threads
                import concurrent.futures as cf
                with cf.ThreadPoolExecutor(cfg.threads) as pool:
                    futs = {
                        ri: pool.submit(self._finalize_read, reads[ri],
                                        codes[ri], parts, sk, batcher)
                        for ri, parts, sk in pending}
                    for ri, fut in futs.items():
                        out[ri] = fut.result()
            else:
                for ri, parts, sk in pending:
                    out[ri] = self._finalize_read(reads[ri], codes[ri],
                                                  parts, sk, batcher)
        STATS.count("reads", len(reads))
        return out

    # -------------------------------------------------------- device stages

    def _seed_and_chain(self, codes, idxs, L, flat_dev=None,
                        flat_offs=None):
        """Device seeding+chaining for one read-length bucket.

        Shape discipline: the batch dim is padded to a power of two so
        jit signatures are drawn from a tiny static set (arbitrary B
        would force a recompile per batch). All six hit arrays come
        back in ONE packed device->host transfer. When the batch's flat
        code array is device-resident (device path), the (B, L) read
        matrix is gathered on device (gather_rc) instead of uploaded."""
        cfg = self.config
        B = len(idxs)
        Bp = max(8, 1 << (B - 1).bit_length())
        # monotonic per-bucket Bp (same ragged-tail signature note as
        # the flat cap): a smaller tail group must reuse the largest
        # seeding signature already compiled for this length bucket
        bp_seen = getattr(self, "_bp_seen", None)
        if bp_seen is None:
            bp_seen = self._bp_seen = {}
        Bp = bp_seen[L] = max(Bp, bp_seen.get(L, 0))
        if self.mesh is not None:
            Bp = max(Bp, self.mesh.devices.size)   # both powers of two
        lens = np.zeros(Bp, np.int32)
        if flat_dev is not None:
            offs = np.zeros(Bp, np.int32)
            for b, ri in enumerate(idxs):
                offs[b] = flat_offs[ri]
                lens[b] = min(len(codes[ri]), L)
            rc = gather_rc(flat_dev, jnp.asarray(offs), jnp.asarray(lens),
                           L=L)
        else:
            rc = np.full((Bp, L), 4, np.uint8)   # 1 byte/base upload
            for b, ri in enumerate(idxs):
                c = codes[ri][:L]
                rc[b, :len(c)] = c
                lens[b] = len(c)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from lamsa_tpu.parallel.mesh import DATA_AXIS
            sh = lambda a, nd: jax.device_put(  # noqa: E731
                a, NamedSharding(self.mesh,
                                 P(DATA_AXIS, *([None] * (nd - 1)))))
            rc, lens = sh(rc, 2), sh(lens, 1)
        common = dict(k=self.k, cands_per_seed=cfg.max_cands_per_seed,
                      max_hits=cfg.max_hits_per_read, weight=self.k,
                      lookback=cfg.chain_lookback,
                      max_dist=cfg.chain_max_dist,
                      diag_slack=cfg.chain_diag_slack)

        def run(grid, sub1=False, rc=rc, lens=lens):
            if self.seed_backend == "kmer":
                if "dense_starts" in self._dev:
                    return _seed_chain_packed_direct(
                        rc, lens, grid, self._dev["dense_starts"],
                        self._dev["dense_counts"], self._dev["pos16"],
                        **common)
                return _seed_chain_packed(
                    rc, lens, grid, self._dev["keys"], self._dev["starts"],
                    self._dev["counts"], self._dev["positions"], **common)
            # genome-scale noise control: a random k-mer still hits
            # ~0.7x per strand in 3.1 Gb, flooding max_hits on long
            # reads; budget hits per (strand, read segment) there
            quota = cfg.max_hits_per_read // 32 \
                if self.ref.total_len > 1_000_000_000 else 0
            return _seed_chain_packed_fm(
                rc, lens, grid, self._dev, sa_rate=self.index.sa_rate,
                seg_quota=quota,
                sub1_cands=cfg.seed_1edit_cands if sub1 else 0,
                sub1_k=self._sub1_k() if sub1 else 0,
                sub1_kinds=cfg.seed_1edit_kinds, **common)

        packed = np.asarray(run(self._grid(L, cfg.seed_step)))[:, :B]
        # Adaptive densification (reference parity: GEM tolerates
        # per-seed edits, SURVEY.md section 1 stage 1; our exact-piece
        # scheme compensates with density). Reads whose BEST chain
        # carries fewer than adaptive_seed_min_anchors anchors' worth
        # of score are past the error envelope of the current grid —
        # retry the batch on a half-step grid and keep the dense
        # result for just those reads. Never triggers inside the
        # design envelope (<= 22% error), so the common path costs one
        # numpy max per batch; the dense signature compiles lazily.
        amin = cfg.adaptive_seed_min_anchors
        if amin and cfg.seed_step >= 4:
            valid = ((packed[1] >> 20) & 1).astype(bool)
            fbest = np.where(valid, packed[2] & 0x7FFFF, 0).max(axis=1)
            lens_h = np.asarray(lens)[:B]
            # score trigger, length-scaled: a long read whose BEST
            # chain is worth only a handful of anchors is deep in the
            # error tail even if it clears the absolute floor. Under
            # an active seg_quota the length scaling is OFF (plain
            # amin floor): quota sampling caps a healthy config-4
            # read's best chain at ~25-30 anchors with a long tail
            # into the teens, where recall holds with NO retry at all —
            # a scaled bar only converts whole batches into sub1 retry
            # passes for zero recall.
            quota_on = self.seed_backend == "fm" \
                and self.ref.total_len > 1_000_000_000
            amin_eff = amin if quota_on else np.maximum(
                amin, lens_h // 256)
            sparse = (fbest < amin_eff * self.k) \
                & (lens_h >= self.k + cfg.seed_step * amin)
            gw = cfg.adaptive_seed_gap_windows
            if gw:
                # coverage trigger: a long read stretch with NO
                # candidate hit on either strand (e.g. a small SV part
                # past the exact-piece envelope) cannot be recovered
                # downstream no matter how well the rest chains — the
                # score trigger never sees it. Gap threshold is
                # measured in VALID seed windows (windows whose k-mer
                # contains an ambiguous base can never hit — counting
                # them made every read spanning a reference N-run
                # fire, at any genome scale). P(a clean window in a
                # stretch) depends on error rate, so at the <= 15%
                # design point 40 windows of silence is ~1e-4/stretch
                # (never fires) while a missed part at 28% error is
                # near-certain silence. GATED on the hit budget not
                # being saturated: when max_hits/seg_quota truncation
                # bit, hit gaps are budget artifacts, not biology.
                nv = valid.sum(axis=1)
                big = np.int64(1) << 30
                qp = packed[1] & 0x7FFFF
                st_ = (packed[1] >> 19) & 1
                coord = np.where(st_ == 1, lens_h[:, None] - qp - self.k,
                                 qp).astype(np.int64)
                c = np.sort(np.where(valid, coord, big), axis=1)
                grid_h = np.asarray(self._grid(L, cfg.seed_step))
                budget_ok = nv < int(0.9 * packed.shape[2])
                for b in np.flatnonzero(budget_ok & ~sparse
                                        & (lens_h > 0)):
                    ri = idxs[b]
                    cb = codes[ri]
                    amb = np.cumsum(
                        np.concatenate([[0], (cb >= 4).astype(np.int64)]))
                    g = grid_h[grid_h + self.k <= len(cb)]
                    vp = g[amb[g + self.k] == amb[g]]   # N-free windows
                    hits = c[b][c[b] < big]
                    edges = np.concatenate([[-1], hits,
                                            [len(cb) - self.k + 1]])
                    lo_i = np.searchsorted(vp, edges[:-1], side="right")
                    hi_i = np.searchsorted(vp, edges[1:], side="left")
                    if (hi_i - lo_i).max(initial=0) >= gw:
                        sparse[b] = True
            if sparse.any():
                STATS.count("seed_densified_reads", int(sparse.sum()))
                # the retry also turns on 1-substitution-tolerant piece
                # search on the FM backend (GEM ≤e-edit parity, SURVEY
                # §7.2a) — the exact-piece envelope is what made these
                # reads sparse in the first place. Only the SPARSE
                # reads re-seed, compacted into a pow2 sub-batch (the
                # variant-track search on a full 10 kb whole-genome
                # batch is far too expensive to pay for one read).
                sel = np.flatnonzero(sparse)
                # Sub-batch cap: the sub1 variant-track key/row arrays
                # scale as B * S_dense * (2C + 2*T*C1) int32 and feed a
                # lax.sort (several times that in scratch). At config-4
                # scale (L=16384, step 5, T=63) an uncapped pow2
                # sub-batch of a 256-read batch builds ~2 GB of sort
                # operands; cap the retry to an element budget and loop.
                step_d = max(2, cfg.seed_step // 2)
                grid_d = self._grid(L, step_d)
                sub1 = self.seed_backend == "fm"
                per_read = int(grid_d.shape[0]) * 2 \
                    * cfg.max_cands_per_seed
                if sub1 and cfg.seed_1edit_cands:
                    k1 = self._sub1_k()
                    T = 3 * k1 * ("s" in cfg.seed_1edit_kinds) \
                        + k1 * ("d" in cfg.seed_1edit_kinds) \
                        + 4 * (k1 - 1) * ("i" in cfg.seed_1edit_kinds)
                    per_read += int(grid_d.shape[0]) * 2 * T \
                        * cfg.seed_1edit_cands
                cap = 1 << max(3, (_RETRY_BUDGET_ELEMS
                                   // max(per_read, 1)).bit_length() - 1)
                Bs = min(cap,
                         max(8, 1 << max(0, len(sel) - 1).bit_length()))
                if self.mesh is not None:
                    Bs = max(Bs, self.mesh.devices.size)
                packed = packed.copy()
                for c0 in range(0, len(sel), Bs):
                    chunk = sel[c0:c0 + Bs]
                    pad_sel = np.concatenate(
                        [chunk, np.full(Bs - len(chunk), int(chunk[0]))])
                    rc_s = jnp.take(rc, jnp.asarray(pad_sel), axis=0)
                    lens_s = jnp.take(lens, jnp.asarray(pad_sel), axis=0)
                    dense = np.asarray(
                        run(grid_d, sub1=sub1,
                            rc=rc_s, lens=lens_s))[:, :len(chunk)]
                    # union-merge: the retry only ADDS evidence.
                    # Replacing hits wholesale let max_hits truncation
                    # on the denser grid drop a small part's hits that
                    # the sparse grid kept (measured part-recall
                    # regressions); merging both sets and re-chaining
                    # on device cannot lose anything either grid found.
                    packed[:, chunk] = self._merge_rechain(
                        packed[:, chunk], dense, common)
        return {
            "rpos": packed[0].view(np.uint32).astype(np.int64),
            "qpos": packed[1] & 0x7FFFF,
            "strand": (packed[1] >> 19) & 1,
            "valid": ((packed[1] >> 20) & 1).astype(bool),
            "f": packed[2] & 0x7FFFF,
            "pred": (packed[2] >> 19) - 1,
        }

    @staticmethod
    def _merge_rechain(p0, p1, common):
        """Union of two packed seed+chain results (3, n, H): decode
        both hit sets, merge + dedup per read, drop diagonal-band
        singletons/pairs, re-chain on device. Output rows keep the
        (strand, qpos, rpos) sort the chain kernel requires; overflow
        past H is truncated after dedup."""
        n, H = p0.shape[1], p0.shape[2]
        if n == 0:
            return p0

        def dec(p):
            q = (p[1] & 0x7FFFF).astype(np.int64)
            r = p[0].view(np.uint32).astype(np.int64)
            s = ((p[1] >> 19) & 1).astype(np.int64)
            v = ((p[1] >> 20) & 1).astype(bool)
            return np.where(v, (s << 51) | (q << 32) | r, _MERGE_INV)

        key = np.sort(np.concatenate([dec(p0), dec(p1)], axis=1), axis=1)
        dup = np.concatenate([np.zeros((n, 1), bool),
                              key[:, 1:] == key[:, :-1]], axis=1)
        key = np.where(dup, _MERGE_INV, key)
        # Diagonal voting: the 1-edit variant tracks add uniform random
        # hits (~0.1/window), and a random PAIR inside one (diag_slack,
        # chain_max_dist) volume forms a plausible 2-anchor chain — a
        # handful of those per read fragment the true part through
        # foreign-gap splitting, and the noise between true anchors
        # can push real predecessors beyond the chain lookback
        # (measured: part coverage collapse at 28% error). True loci
        # concentrate many hits in one diagonal band; keep only hits
        # with >= 3 same-strand hits within +-2 bands (band width =
        # diag_slack). Runs after dedup so a hit found by both grids
        # votes once.
        slack = max(int(common["diag_slack"]), 1)
        valid = key < _MERGE_INV
        qpos_a = (key >> 32) & 0x7FFFF
        diag = (key & 0xFFFFFFFF) - qpos_a
        band = np.where(valid, (key >> 51 << 40) + diag // slack, -1)
        for i in range(n):
            b = band[i][valid[i]]
            if len(b) == 0:
                continue
            ub, cnt = np.unique(b, return_counts=True)
            cmap = dict(zip(ub.tolist(), cnt.tolist()))
            votes = np.fromiter(
                (cmap.get(x, 0) + cmap.get(x - 1, 0) + cmap.get(x + 1, 0)
                 for x in b.tolist()), np.int64, len(b))
            kill = np.flatnonzero(valid[i])[votes < 3]
            key[i, kill] = _MERGE_INV
        key = np.sort(key, axis=1)[:, :H]
        valid = key < _MERGE_INV
        qpos = np.where(valid, (key >> 32) & 0x7FFFF, 0).astype(np.int32)
        rpos = np.where(valid, key & 0xFFFFFFFF, 0).astype(np.uint32)
        strand = np.where(valid, key >> 51, 0).astype(np.int32)
        npad = max(8, 1 << (n - 1).bit_length())   # closed signature set
        if npad != n:
            pad = ((0, npad - n), (0, 0))
            qpos = np.pad(qpos, pad)
            rpos = np.pad(rpos, pad)
            strand = np.pad(strand, pad)
            valid = np.pad(valid, pad)
        out = np.asarray(_chain_packed_only(
            qpos, rpos, strand, valid, weight=common["weight"],
            lookback=common["lookback"], max_dist=common["max_dist"],
            diag_slack=common["diag_slack"]))
        return out[:, :n]

    def _sub1_k(self) -> int:
        """Piece length for the 1-edit variant tracks: smallest k1 >= k
        whose ~8*k1 variant patterns expect < 0.15 random hits per
        window (deletion tracks are length k1-1, hence the extra
        weight) — variant noise must not flood max_hits
        (seed_hits_fm docstring; 15 at 1 Mb, 18 at 64 Mb, 21 at
        GRCh38 scale)."""
        t = max(int(self.ref.total_len), 1)
        k1 = self.k
        while 8 * k1 * t / (4 ** k1) > 0.15 and k1 < 24:
            k1 += 1
        return k1

    def _grid(self, L, step):
        """Static qpos sample grid per (bucket length, step), cached +
        replicated; the dense half-step grids only materialize (and
        compile) when adaptive densification first fires."""
        key = (L, step)
        if key not in self._grids:
            g = make_qpos_grid(L, self.k, step)
            if self._rep is not None:
                g = jax.device_put(g, self._rep)
            self._grids[key] = g
        return self._grids[key]

    def _build_skeleton(self, h, gi, read_len):
        return build_skeleton(
            h["f"][gi], h["pred"][gi], h["qpos"][gi], h["rpos"][gi],
            h["strand"][gi], h["valid"][gi], k=self.k,
            read_len=read_len, ref=self.ref, config=self.config)

    # ------------------------------------------------------- part alignment

    @staticmethod
    def _qdesc(off, L, strand, w0, m, rev):
        """Device-gather descriptor for an oriented-read window:
        element y of the window = flat[q_base + q_step * y],
        complemented when strand == 1. w0 = window start in ORIENTED
        read coordinates, m = window length, rev = emitted reversed
        (left extensions)."""
        first_y = w0 + m - 1 if rev else w0
        first = off + (first_y if strand == 0 else L - 1 - first_y)
        step = -1 if (strand ^ rev) else 1
        return (int(first), step, int(strand))

    # Gap-coalescing geometry: a 10 kb read yields ~200 seed blocks,
    # and per-gap DP instances make the pipeline per-instance-bound
    # (descriptor + compact-wire words + host decode per tiny ~35-base
    # gap). Consecutive (gap, block) units are coalesced into ONE
    # global DP spanning from block s's end to block e's end whenever
    # the q-span stays under _GROUP_SPAN and the path's diagonal range
    # under _GROUP_DRIFT. _GROUP_DRIFT <= 56 keeps the W=128 band
    # sound: anchors preserve diagonals, so the true path's diagonal
    # at every unit boundary lies within the block-end diagonal range
    # R; the endpoint-centered band of global_lo leaves
    # (W - |n-m| - 1)//2 slack, and R <= 56 implies the excursion
    # need R - |n-m| <= that slack for every endpoint split, with
    # >= 24 margin left for within-gap
    # error drift (_MIN_SLACK). Groups whose drift range exceeds the
    # cap fall back to per-unit instances.
    _GROUP_SPAN = 448
    _GROUP_DRIFT = 56

    @staticmethod
    def _group_blocks(qe_b, re_b):
        """Group boundaries over block-end coords: returns (bnds, rng);
        `bnds` is an int array of block indices — group k spans
        end(block bnds[k]) -> end(block bnds[k+1]) — and rng[k] is the
        group's block-end diagonal range (0 for per-unit fallback
        groups; used by the caller to route wide-drift groups onto the
        W=256 band). Quantized q-span grouping: a group may straddle
        two adjacent quanta, so max group m <= 2*_GROUP_SPAN - 1 (895;
        still inside the 1024 bucket). Groups whose block-end diagonal
        range exceeds _GROUP_DRIFT fall back to per-unit instances."""
        n = len(qe_b)
        if n <= 1:
            return np.zeros(1, np.int64), np.zeros(0, np.int64)
        grp = (qe_b - qe_b[0]) // Aligner._GROUP_SPAN
        # last block index of each quantum, always including block n-1
        last = np.flatnonzero(np.concatenate(
            [grp[1:] != grp[:-1], np.ones(1, bool)]))
        d = (re_b - qe_b) - (re_b[0] - qe_b[0])
        bnds = [0]
        rng = []
        for e in last:
            s = bnds[-1]
            if e <= s:
                continue
            seg = d[s:e + 1]
            r = int(seg.max() - seg.min())
            if r > Aligner._GROUP_DRIFT:
                bnds.extend(range(s + 1, e + 1))   # per-unit fallback
                rng.extend([0] * (e - s))
            else:
                bnds.append(int(e))
                rng.append(r)
        return np.asarray(bnds, np.int64), np.asarray(rng, np.int64)

    def _enqueue_parts(self, sk, read_codes, batcher,
                       flat_off=None) -> list[_PendingPart]:
        cfg = self.config
        L = len(read_codes)
        rc_codes = None
        pend = []
        n_parts = len(sk.parts)
        part_list = list(sk.parts) + list(sk.secondaries)
        for pi, part in enumerate(part_list):
            is_secondary = pi >= n_parts
            blocks = anchors_to_blocks(part.anchors, self.k)
            if len(blocks) == 0:
                continue

            # read-space neighbor bounds -> oriented coords
            # (secondaries extend freely within the read)
            read_lo = sk.parts[pi - 1].read_end \
                if 0 < pi < n_parts else 0
            read_hi = sk.parts[pi + 1].read_start \
                if pi < n_parts - 1 else L
            read_lo = min(read_lo, part.read_start)
            read_hi = max(read_hi, part.read_end)
            if part.strand == 0:
                o_lo, o_hi = read_lo, read_hi
            else:
                o_lo, o_hi = L - read_hi, L - read_lo

            q0, r0 = int(blocks[0][0]), int(blocks[0][1])
            ls = max(int(o_lo), q0 - _EXT_CAP)
            qe = int(blocks[-1][0] + blocks[-1][2])
            re_ = int(blocks[-1][1] + blocks[-1][2])
            rs2 = min(int(o_hi), qe + _EXT_CAP)
            tlen_l = min(q0 - ls + EXT_MARGIN, r0)
            tlen_r = min(rs2 - qe + EXT_MARGIN, self.ref.total_len - re_)

            # coalesced spans: group k = end(block bnds[k]) ->
            # end(block bnds[k+1]), one global DP each (covers the
            # gaps AND interior anchors of the span — anchors are
            # exact matches, so DP recovers their diagonals; see
            # _GROUP_SPAN note above)
            qe_b = blocks[:, 0] + blocks[:, 2]
            re_b = blocks[:, 1] + blocks[:, 2]
            bnds, rng = self._group_blocks(qe_b, re_b)
            s_, e_ = bnds[:-1], bnds[1:]
            qa_ = qe_b[s_]
            ra_ = re_b[s_]
            mlen = qe_b[e_] - qa_
            nlen = re_b[e_] - ra_
            # band routing: a group whose interior diagonal range rng
            # does not leave _MIN_SLACK drift margin inside the W=128
            # band must ride W=256 (the W=256 slack is always >=
            # rng + _MIN_SLACK for rng <= _GROUP_DRIFT)
            from lamsa_tpu.pipeline.extend import (_MIN_SLACK,
                                                   MAX_BUCKET_M)
            need = np.abs(nlen - mlen) + 1
            minw = np.where((128 - need) // 2 < rng + _MIN_SLACK,
                            256, 0)
            # a unit whose q-gap + trailing anchor exceeds the largest
            # bucket M fits no bucket (chained gaps alone are <=
            # chain_max_dist <= MAX_BUCKET_M, but the merged anchor
            # block after it can be arbitrarily long): emit the gap
            # alone and the anchor as an explicit exact M run
            anchors_after = None
            over = mlen > MAX_BUCKET_M
            if over.any():
                STATS.count("dp_oversize_unit_split", int(over.sum()))
                anchors_after = np.where(over, blocks[e_, 2], 0)
                mlen = np.where(over, blocks[e_, 0] - qa_, mlen)
                nlen = np.where(over, blocks[e_, 1] - ra_, nlen)

            def _with_anchors(h0):
                handles = list(range(h0, h0 + len(mlen)))
                if anchors_after is None:
                    return handles
                gh = []
                for i, h in enumerate(handles):
                    gh.append(h)
                    if anchors_after[i]:
                        gh.append(("M", int(anchors_after[i])))
                return gh

            if flat_off is not None:
                # descriptor path (device-gather engine): no host
                # content slices at all — span descriptors are built
                # vectorized and bulk-enqueued
                if part.strand == 0:
                    q_base = flat_off + qa_
                else:
                    q_base = flat_off + (L - 1 - qa_)
                h0 = batcher.add_globals_bulk(
                    mlen, nlen, q_base, 1 if part.strand == 0 else -1,
                    part.strand, ra_, minw=minw)
                gap_handles = _with_anchors(h0)
                left_handle = batcher.add_extend_desc(
                    q0 - ls, tlen_l, cfg.scores.end_bonus,
                    self._qdesc(flat_off, L, part.strand, ls, q0 - ls, 1),
                    (r0 - 1, -1))
                right_handle = batcher.add_extend_desc(
                    rs2 - qe, tlen_r, cfg.scores.end_bonus,
                    self._qdesc(flat_off, L, part.strand, qe, rs2 - qe, 0),
                    (re_, 1))
            else:
                # content path (host/XLA engine) — same spans, so SAM
                # stays byte-identical across engines
                if part.strand == 0:
                    qseq = read_codes
                else:
                    if rc_codes is None:
                        rc_codes = _revcomp_codes(read_codes)
                    qseq = rc_codes
                handles = []
                for i in range(len(mlen)):
                    handles.append(batcher.add_global(
                        qseq[int(qa_[i]):int(qa_[i] + mlen[i])],
                        self.ref.codes[int(ra_[i]):int(ra_[i] + nlen[i])],
                        minw=int(minw[i])))
                gap_handles = []
                for i, h in enumerate(handles):
                    gap_handles.append(h)
                    if anchors_after is not None and anchors_after[i]:
                        gap_handles.append(("M", int(anchors_after[i])))
                left_handle = batcher.add_extend(
                    qseq[ls:q0][::-1],
                    self.ref.codes[r0 - tlen_l:r0][::-1],
                    cfg.scores.end_bonus)
                right_handle = batcher.add_extend(
                    qseq[qe:rs2], self.ref.codes[re_:re_ + tlen_r],
                    cfg.scores.end_bonus)
            pend.append(_PendingPart(part=part, blocks=blocks,
                                     gap_handles=gap_handles,
                                     left_handle=left_handle,
                                     right_handle=right_handle,
                                     o_lo=o_lo, o_hi=o_hi,
                                     secondary=is_secondary))
        return pend

    def _finalize_read(self, read, read_codes, pend, sk, batcher):
        cfg = self.config
        L = len(read_codes)
        if not pend:
            return [unmapped_record(read.name, read.seq, read.qual)]

        finals = []
        seconds = []
        for pp in pend:
            rec = self._finalize_part(pp, read_codes, sk, batcher, L)
            if rec is not None:
                (seconds if pp.secondary else finals).append(rec)
        if not finals:
            return [unmapped_record(read.name, read.seq, read.qual)]

        # primary = best score; others supplementary
        finals.sort(key=lambda fr: (-fr["score"], fr["read_start"]))
        records = []
        rc_seq = rc_qual = None
        for rank, fr in enumerate(finals):
            flag = 0
            if fr["strand"] == 1:
                flag |= FLAG_REVERSE
            if rank > 0:
                flag |= FLAG_SUPPLEMENTARY
            if fr["strand"] == 0:
                seq, qual = read.seq, read.qual
            else:
                if rc_seq is None:
                    rc_seq = read.seq.translate(_RC_TRANS)[::-1]
                    rc_qual = read.qual[::-1] if read.qual else None
                seq, qual = rc_seq, rc_qual
            sid, local_pos = self.ref.global_to_local(fr["pos"])
            tags = {"NM": fr["nm"], "AS": fr["score"]}
            if fr.get("md"):
                tags["MD"] = fr["md"]
            if cfg.rg_id:
                tags["RG"] = cfg.rg_id
            records.append(SamRecord(
                qname=read.name, flag=flag, rname=self.ref.names[sid],
                pos=local_pos, mapq=fr["mapq"], cigar=fr["cigar"], seq=seq,
                qual=qual, tags=tags))
        if len(records) > 1:
            for i, rec in enumerate(records):
                others = [r.sa_item() for j, r in enumerate(records)
                          if j != i]
                rec.tags["SA"] = ";".join(others) + ";"
        if sk.alt_score > 0:
            records[0].tags["XS"] = sk.alt_score
        # secondary alignments (0x100): rejected overlapping chains
        from lamsa_tpu.io.sam import FLAG_SECONDARY
        for fr in seconds:
            sid, local_pos = self.ref.global_to_local(fr["pos"])
            flag = FLAG_SECONDARY | (FLAG_REVERSE if fr["strand"] else 0)
            tags = {"NM": fr["nm"], "AS": fr["score"]}
            records.append(SamRecord(
                qname=read.name, flag=flag, rname=self.ref.names[sid],
                pos=local_pos, mapq=0, cigar=fr["cigar"], seq="",
                qual=None, tags=tags))
        if sk.events and any(e["type"] != "gap" for e in sk.events):
            sv = ",".join(e["type"] for e in sk.events if e["type"] != "gap")
            for rec in records:
                rec.tags["sv"] = sv
        return records

    def _finalize_part(self, pp, read_codes, sk, batcher, L):
        cfg = self.config
        part = pp.part
        qseq = read_codes if part.strand == 0 else _revcomp_codes(read_codes)
        blocks = pp.blocks
        match = cfg.scores.match

        # stitch the part's CIGAR as packed uint32 runs (no per-run
        # Python objects on this hot path; io/sam.py::cigar_pairs)
        score = 0
        left = batcher.result(pp.left_handle)
        right = batcher.result(pp.right_handle)

        q0, r0 = int(blocks[0][0]), int(blocks[0][1])
        qs_cov = q0 - left.q_used
        pos = r0 - left.t_used
        score += left.score

        # stitch: left_ext | M(block 0) | span DPs | right_ext —
        # interior anchors live inside the coalesced span results
        la0 = int(blocks[0, 2])
        segs = [left.cigar[::-1],
                np.array([(la0 << 4) | OP_M], np.uint32)]
        score += la0 * match
        for h in pp.gap_handles:
            if isinstance(h, tuple):      # ("M", len): explicit anchor
                _, ln = h                 # run after an oversize unit
                segs.append(np.array([(ln << 4) | OP_M], np.uint32))
                score += ln * match
                continue
            g = batcher.result(h)
            segs.append(g.cigar)
            score += g.score

        qe = int(blocks[-1][0] + blocks[-1][2])
        segs.append(right.cigar)
        score += right.score
        qe_cov = qe + right.q_used

        merged = merge_runs(np.concatenate(segs))
        if not ((merged & 0xF) == OP_M).any():
            return None
        # canonical SAM boundaries: an extension's to-end path may end
        # (or a gap at the part edge may start) with an insertion or
        # deletion run; convert boundary I into soft clip (shrinking the
        # covered query span) and drop boundary D (advancing pos on the
        # left). AS keeps the DP score; NM/MD are computed after.
        merged, pos, qs_cov, qe_cov = _trim_boundary_indels(
            merged, pos, qs_cov, qe_cov)
        if merged is None:
            return None

        from lamsa_tpu import native
        from lamsa_tpu.io.sam import cigar_ref_len
        ref_len = cigar_ref_len(merged)
        q_win = qseq[qs_cov:qe_cov]
        t_win = self.ref.codes[pos:pos + ref_len]
        nm = native.nm_from_cigar(q_win, t_win, merged)
        md = None
        if cfg.emit_md:
            from lamsa_tpu.pipeline.extend import md_tag
            md = md_tag(q_win, t_win, merged)

        clips = [merged]
        if qs_cov > 0:
            clips.insert(0, np.array([(qs_cov << 4) | OP_S], np.uint32))
        if qe_cov < L:
            clips.append(np.array([((L - qe_cov) << 4) | OP_S], np.uint32))
        cigar = np.concatenate(clips) if len(clips) > 1 else merged

        mapq = self._mapq(part, sk)
        # read-space span of the final alignment
        if part.strand == 0:
            rs, re_ = qs_cov, qe_cov
        else:
            rs, re_ = L - qe_cov, L - qs_cov
        return {"strand": part.strand, "pos": pos, "cigar": cigar,
                "score": score, "nm": nm, "md": md, "mapq": mapq,
                "read_start": rs, "read_end": re_}

    def _mapq(self, part, sk) -> int:
        """MAPQ from chain-score margin (our own documented formula; the
        reference's exact formula is unrecoverable — empty mount,
        SURVEY.md section 0): 40 * (1 - alt/score) scaled by anchor
        count, clamped to [0, 60].

        Calibrated on TWO repeat worlds: the duplicated-block world
        (tests/test_mapq.py: >= 99.9% correct at MAPQ >= 30, ambiguous
        copies land < 30 because rejected same-coverage chains feed
        alt_score) and the tandem/family/segdup world
        (tools/repeat_bench.py): there, every confidently-wrong record
        had a strong competing chain (alt 65-85% of score — a diverged
        family/segdup copy) that a FLAT +20 anchor bonus pushed past
        30 anyway. The whole scale is margin-multiplicative, so no
        anchor count can buy confidence a live competitor contradicts
        (tests/test_mapq.py pins the wrong-at->=30 rate)."""
        s1 = max(part.score, 1)
        s2 = max(sk.alt_score, 0)
        if s2 >= s1:
            return 0
        m = 60.0 * (1.0 - s2 / s1) * min(1.0, part.n_anchors / 16.0)
        return int(max(0, min(60, round(m))))


def align_reads(ref: PackedReference, index: KmerIndex, reads,
                config: AlignConfig | None = None,
                batch_size: int | None = None,
                pipeline: int | None = None,
                aligner: "Aligner | None" = None,
                mesh=None):
    """Align an iterable of reads, yielding SAM record lists per read in
    input order.

    pipeline — number of batches in flight (default 3 on the device
    path, 1 on the CPU engine): while the device waits inside batch
    k+1's seeding/DP dispatches the GIL is released, so batch k's
    host-side skeleton/finalize Python runs concurrently — the
    analogue of the reference's pthread overlap of I/O and compute.

    aligner — reuse a prepared Aligner (keeps the reference and jit
    caches warm across calls)."""
    cfg = config or AlignConfig()
    aligner = aligner or Aligner(ref, index, cfg, mesh=mesh)
    bs = batch_size or cfg.batch_reads
    if pipeline is None:
        # depth 3: the host skeleton/finalize of one batch overlaps the
        # device and transfer time of two
        pipeline = 3 if aligner.device_path else 1

    if pipeline <= 1:
        batch: list = []
        for r in reads:
            batch.append(r)
            if len(batch) >= bs:
                yield from aligner.align_batch(batch)
                batch = []
        if batch:
            yield from aligner.align_batch(batch)
        return

    import collections
    import concurrent.futures as cf
    futs: collections.deque = collections.deque()
    with cf.ThreadPoolExecutor(pipeline) as ex:
        batch = []
        for r in reads:
            batch.append(r)
            if len(batch) >= bs:
                futs.append(ex.submit(aligner.align_batch, batch))
                batch = []
                while len(futs) >= pipeline:
                    yield from futs.popleft().result()
        if batch:
            futs.append(ex.submit(aligner.align_batch, batch))
        while futs:
            yield from futs.popleft().result()
