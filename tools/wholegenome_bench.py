"""Config-4 working point: GRCh38-scale genome, 10 kb reads, pipelined.

The primary metric's read class is 9-11 kb and the production
configuration is the 3-deep batch pipeline — this tool measures
exactly that.

Artifacts are cached under --workdir (default .bench_work/ in the
repository):
  genome.npz        packed 3.1 Gb synthetic genome (24 chroms, N runs)
  index/            PackedReference + FM-index (.lti layout, native
                    SA-IS build: ~26 min single-core, ~52 GB peak RSS)
so re-runs skip straight to alignment. Run:
  python tools/wholegenome_bench.py [--reads 384] [--batch 128]
Prints one JSON line with pipelined reads/s, recall, and stage walls.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

GENOME_LEN = 3_100_000_000
N_CHROM = 24
N_RUNS = 200                    # N-runs sprinkled across chromosomes
SEED = 20260820


def log(msg):
    print(f"[wg_bench] {msg}", file=sys.stderr, flush=True)


def build_genome(workdir):
    """3.1 Gb synthetic genome as a PackedReference, cached on disk."""
    from lamsa_tpu.io.refpack import PackedReference
    idx_dir = os.path.join(workdir, "index")
    if os.path.isdir(idx_dir) and os.path.exists(
            os.path.join(idx_dir, "ref2bit.npy")):
        log("loading cached PackedReference")
        return PackedReference.load(idx_dir), idx_dir
    rng = np.random.default_rng(SEED)
    per = GENOME_LEN // N_CHROM
    names, codes_parts, offsets = [], [], [0]
    t0 = time.time()
    for c in range(N_CHROM):
        codes = rng.integers(0, 4, per, dtype=np.uint8)
        for _ in range(N_RUNS // N_CHROM):
            p = int(rng.integers(0, per - 2000))
            codes[p:p + int(rng.integers(100, 2000))] = 4
        codes_parts.append(codes)
        names.append(f"chr{c + 1}")
        offsets.append(offsets[-1] + per)
        log(f"chr{c + 1} generated ({time.time() - t0:.0f}s)")
    from lamsa_tpu.io.refpack import _find_runs
    codes = np.concatenate(codes_parts)
    ref = PackedReference(names=names,
                          offsets=np.asarray(offsets, np.int64),
                          codes=codes,
                          amb_runs=_find_runs(codes >= 4))
    os.makedirs(idx_dir, exist_ok=True)
    ref.save(idx_dir)
    return ref, idx_dir


def build_index(ref, idx_dir):
    from lamsa_tpu.index.fmindex import FmIndex
    if FmIndex.exists(idx_dir):
        log("loading cached FM-index")
        t0 = time.time()
        fm = FmIndex.load(idx_dir)
        log(f"FM-index loaded ({time.time() - t0:.0f}s)")
        return fm, 0.0
    log("building FM-index (native SA-IS; ~26 min, ~52 GB RSS)")
    t0 = time.time()
    fm = FmIndex.build(ref.codes)
    dt = time.time() - t0
    fm.save(idx_dir)
    log(f"FM build {dt / 60:.1f} min")
    return fm, dt


def sample_reads(ref, n_reads, rng):
    """10 kb reads simulated from genome windows (decoding the whole
    3.1 Gb to str for sim.simulate_reads would need ~25 GB; instead
    sample windows, decode only those, and rebase the truth coords in
    the read names from window-relative to chromosome-relative so
    eval.evaluate works unchanged)."""
    from lamsa_tpu import sim
    from lamsa_tpu.io.fasta import BASES, FastxRecord
    reads = []
    lut = np.frombuffer("".join(BASES).encode(), np.uint8)
    total = int(ref.total_len)
    offs = np.asarray(ref.offsets)
    WIN = 40_000
    while len(reads) < n_reads:
        w0 = int(rng.integers(0, total - WIN))
        ci = int(np.searchsorted(offs, w0, side="right")) - 1
        if w0 + WIN > offs[ci + 1]:          # window straddles chroms
            continue
        win = ref.codes[w0:w0 + WIN]
        if (win >= 4).mean() > 0.01:
            continue
        seq = lut[np.minimum(win, 4)].tobytes().decode()
        sub = sim.simulate_reads(
            rng, [FastxRecord(name="win", seq=seq)], 1,
            read_len=(9000, 11000), sub=0.02, ins=0.04, dele=0.04,
            sv_fraction=0.15, name_prefix=f"wg{len(reads)}")
        (r,) = sub
        base = w0 - int(offs[ci])
        pref, enc = r.name.split("|", 1)
        parts = []
        for ps in enc.split(";"):
            p = sim.TruthPart.decode(ps)
            p.ref_name = ref.names[ci]
            p.ref_start += base
            p.ref_end += base
            parts.append(p.encode())
        reads.append(FastxRecord(name=pref + "|" + ";".join(parts),
                                 seq=r.seq, qual=r.qual))
    return reads[:n_reads]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench_work"))
    ap.add_argument("--reads", type=int, default=384)
    ap.add_argument("--batch", type=int, default=256)   # one default
    # config across scales
    args = ap.parse_args()
    os.makedirs(args.workdir, exist_ok=True)

    from lamsa_tpu.config import AlignConfig, ScoreParams
    from lamsa_tpu.pipeline.aln import Aligner, align_reads
    from lamsa_tpu.utils.timers import GLOBAL as STATS

    ref, idx_dir = build_genome(args.workdir)
    fm, build_s = build_index(ref, idx_dir)
    cfg = AlignConfig(scores=ScoreParams(), seed_step=10)

    rng = np.random.default_rng(SEED + 1)
    reads = sample_reads(ref, args.reads + args.batch, rng)
    log(f"{len(reads)} reads simulated")

    t0 = time.time()
    aligner = Aligner(ref, fm, cfg)
    log(f"Aligner init (device residency) {time.time() - t0:.0f}s")
    t0 = time.time()
    aligner.align_batch(reads[:args.batch])
    warm_s = time.time() - t0
    log(f"warmup batch incl. compiles: {warm_s:.0f}s")

    STATS.reset()
    t0 = time.time()
    out = list(align_reads(ref, fm, reads[args.batch:], cfg,
                           batch_size=args.batch, aligner=aligner))
    dt = time.time() - t0
    rps = args.reads / dt
    log(f"pipelined: {rps:.1f} reads/s over {args.reads} reads")
    log(STATS.report())

    st = None
    try:
        from lamsa_tpu.eval import evaluate
        st = evaluate(out, reads[args.batch:])
    except Exception as e:  # noqa: BLE001
        log(f"evaluate failed: {e}")
    result = {
        "metric": "wholegenome_10kb_reads_per_s_pipelined",
        "value": round(rps, 2),
        "genome_bp": GENOME_LEN,
        "fm_build_s": round(build_s, 1),
        "warmup_s": round(warm_s, 1),
        "part_recall": round(st.part_recall, 4) if st else None,
        "read_accuracy": round(st.read_accuracy, 4) if st else None,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
