"""Benchmark entry point (needs a GPU; fails without one).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Primary metric: end-to-end reads/s/chip on a config-1-style workload
(E. coli-scale genome + simulated 1-5 kb PacBio CLR reads,
BASELINE.json:7). The reference LAMSA binary is not present in this
environment (empty mount, SURVEY.md section 0), so vs_baseline is
measured against this framework's own CPU engine (XLA kernels + host
traceback) on the same workload — the honest stand-in for a CPU
aligner baseline. Extras report the fused banded-DP chain's device
Gcells/s per (M, W) bucket and the device-vs-CPU-engine SAM agreement
rate (both engines share bit-identical semantics, so this should be
1.0). Every result names the device it ran on.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

GENOME_LEN = 4_600_000          # E. coli scale
N_READS = 512
READ_LEN = (1000, 5000)
SEED = 20260817

_CPU_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          ".bench_cpu_baseline.json")


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def scores():
    """The scoring `lamsa aln` runs with by default (-A 1 -B 3 -O 2
    -E 1)."""
    from lamsa_tpu.config import ScoreParams
    return ScoreParams(match=1, mismatch=3, gap_open=2, gap_ext=1)


def build_world():
    from lamsa_tpu import sim
    from lamsa_tpu.config import AlignConfig
    from lamsa_tpu.index.kmer import KmerIndex
    from lamsa_tpu.io.fasta import encode_seq
    from lamsa_tpu.io.refpack import PackedReference

    rng = np.random.default_rng(SEED)
    genome = sim.random_genome(rng, GENOME_LEN)
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    offsets = np.zeros(2, np.int64)
    offsets[1] = len(codes)
    ref = PackedReference(names=[genome[0].name], offsets=offsets,
                          codes=codes, amb_runs=np.zeros((0, 2), np.int64))
    idx = KmerIndex.build(codes, 13)
    cfg = AlignConfig(scores=scores(), seed_step=10)
    reads = sim.simulate_reads(rng, genome, N_READS, read_len=READ_LEN,
                               sub=0.01, ins=0.05, dele=0.04,
                               sv_fraction=0.15)
    return genome, ref, idx, cfg, reads


def _stable_reps(run_once, n_reps, name, warm_tol=0.05, max_warm=6):
    """Warm-until-stable, then median-of-n scored reps.

    Scored reps start once consecutive passes agree within warm_tol.
    The headline spread is TRIMMED — computed over the middle n-2 reps
    when n >= 4 — with every raw rep reported alongside. Returns
    (median, scored_reps, spread_trimmed, spread_raw)."""
    prev = None
    for w in range(max_warm + 1):
        cur = run_once()
        log(f"{name} warm{w}: {cur:.2f} reads/s")
        if prev is not None and abs(cur - prev) <= warm_tol * prev:
            break
        prev = cur
    reps = []
    for i in range(n_reps):
        r = run_once()
        log(f"{name} rep{i}: {r:.2f} reads/s")
        reps.append(r)
    med = sorted(reps)[len(reps) // 2]
    raw = (max(reps) - min(reps)) / med if med else 0.0
    mid = sorted(reps)[1:-1] if len(reps) >= 4 else sorted(reps)
    trim = (max(mid) - min(mid)) / med if med else 0.0
    return med, reps, trim, raw


def bench_e2e(ref, idx, cfg, reads, batch=256):
    from lamsa_tpu.eval import evaluate
    from lamsa_tpu.pipeline.aln import Aligner, align_reads

    aligner = Aligner(ref, idx, cfg)      # device index/ref residency
    t0 = time.time()
    aligner.align_batch(reads[:batch])    # compiles all bucket sigs
    log(f"warmup batch ({batch} reads) incl. compiles: "
        f"{time.time() - t0:.1f}s")

    box = {}

    def run_once():
        t0 = time.time()
        box["out"] = list(align_reads(ref, idx, reads, cfg,
                                      batch_size=batch, aligner=aligner))
        return len(reads) / (time.time() - t0)

    med, reps, spread, _raw = _stable_reps(run_once, 5, "e2e")
    st = evaluate(box["out"], reads)
    log(f"e2e: median {med:.2f} reads/s (min {min(reps):.2f} max "
        f"{max(reps):.2f}, spread {spread:.2f}); {st.summary()}")
    return med, reps, spread, _raw, st, box["out"]


def chain_case(M, W, seed=0, B=None):
    """One chunk (B instances, default a full CHUNK_BY_M chunk) of
    seeded DP instances for bucket (M, W), as the device chain's
    inputs: (flat_dev, ref_dev, desc, real_cells)."""
    import jax

    from lamsa_tpu import sim
    from lamsa_tpu.ops.banded_sw import (_LO_BIAS, global_lo,
                                         pack_codes_words, pack_desc)
    from lamsa_tpu.pipeline.extend import CHUNK_BY_M
    B = B or CHUNK_BY_M[(M, W)]
    inst = sim.dp_instances(np.random.default_rng(seed), M, W, B)
    it = inst["items"]
    glob = np.array([k == "global" for k, *_ in it])
    m = np.array([x[1] for x in it])
    n = np.array([x[2] for x in it])
    qd = np.array([x[3] for x in it])
    td = np.array([x[4] for x in it])
    lo = np.where(glob, global_lo(m, n, W), -(W // 2))
    desc = np.zeros((B, 4), np.int32)
    desc[len(it):, 3] = _LO_BIAS
    desc[:len(it)] = pack_desc(qd[:, 0], qd[:, 1], qd[:, 2], td[:, 0],
                               td[:, 1], m, n, lo, glob,
                               np.where(glob, 0, 5))
    return (jax.device_put(pack_codes_words(inst["flat"])),
            jax.device_put(pack_codes_words(inst["ref"])),
            jax.device_put(desc), int(m.sum()) * W)


def bench_kernel(reps=5):
    """Device time of the fused production chunk per (M, W) bucket:
    descriptor unpack -> packed-word window gather -> XLA banded DP ->
    traceback walk -> compact wire, i.e. exactly what pipeline
    dispatch runs per chunk, at its CHUNK_BY_M size. Returns
    {bucket: (ms per chunk (min of reps), Gcells/s over real cells)}."""
    from lamsa_tpu.ops.banded_sw import _dp_tb_fused_gather
    from lamsa_tpu.pipeline.extend import BUCKETS

    S = scores()
    kw = dict(match=S.match, mismatch=S.mismatch, gapo=S.gap_open,
              gape=S.gap_ext, zdrop=S.zdrop)
    out = {}
    for M, W in BUCKETS:
        flat, refd, desc, cells = chain_case(M, W)
        _dp_tb_fused_gather(flat, refd, desc, M=M, W=W,
                            **kw).block_until_ready()   # compile
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _dp_tb_fused_gather(flat, refd, desc, M=M, W=W,
                                **kw).block_until_ready()
            samples.append(time.perf_counter() - t0)
        t = min(samples)
        out[(M, W)] = (t * 1e3, cells / t / 1e9)
        log(f"fused chunk ({M}, {W}): {t*1e3:.2f} ms/chunk -> "
            f"{cells / t / 1e9:.3f} Gcells/s (samples ms: "
            f"{', '.join(f'{x*1e3:.2f}' for x in sorted(samples))})")
    return out


def cpu_baseline(n_reads=64):
    """Same pipeline on the CPU engine, in a subprocess that pins the
    CPU platform before any JAX call (one process per card: the child
    never opens the GPU)."""
    if os.path.exists(_CPU_CACHE):
        with open(_CPU_CACHE) as fh:
            c = json.load(fh)
        if c.get("seed") == SEED and c.get("n_reads") == n_reads:
            log(f"cpu baseline (cached): {c['reads_per_s']:.2f} reads/s")
            return c["reads_per_s"]
    code = f"""
import sys, time, json
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np
import bench
genome, ref, idx, cfg, reads = bench.build_world()
reads = reads[:{n_reads}]
from lamsa_tpu.pipeline.aln import Aligner
a = Aligner(ref, idx, cfg)
a.align_batch(reads[:32])          # compile warmup
t0 = time.time()
a.align_batch(reads)
dt = time.time() - t0
print(json.dumps({{"reads_per_s": len(reads)/dt}}))
"""
    try:
        r = subprocess.run([sys.executable, "-c", code], timeout=1800,
                           capture_output=True, text=True)
        val = json.loads(r.stdout.strip().splitlines()[-1])["reads_per_s"]
        with open(_CPU_CACHE, "w") as fh:
            json.dump({"seed": SEED, "n_reads": n_reads,
                       "reads_per_s": val}, fh)
        log(f"cpu baseline: {val:.2f} reads/s")
        return val
    except Exception as e:  # noqa: BLE001
        log(f"cpu baseline failed ({e}); using vs_baseline=0")
        return 0.0


def sam_agreement(ref, idx, cfg, reads, dev_out, n=64):
    """Record-level agreement between the device and CPU engines."""
    from lamsa_tpu.io.sam import format_sam_record
    sub = reads[:n]
    code_in = [format_sam_record(r) for recs in dev_out[:n] for r in recs]
    import pickle
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as fh:
        pickle.dump([(r.name, r.seq, r.qual) for r in sub], fh)
        path = fh.name
    code = f"""
import sys, pickle
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
import jax; jax.config.update("jax_platforms", "cpu")
import bench
from lamsa_tpu.io.fasta import FastxRecord
from lamsa_tpu.io.sam import format_sam_record
from lamsa_tpu.pipeline.aln import Aligner
genome, ref, idx, cfg, reads = bench.build_world()
with open({path!r}, "rb") as fh:
    rs = [FastxRecord(*t) for t in pickle.load(fh)]
a = Aligner(ref, idx, cfg)
out = a.align_batch(rs)
for recs in out:
    for r in recs:
        print(format_sam_record(r))
"""
    try:
        r = subprocess.run([sys.executable, "-c", code], timeout=1800,
                           capture_output=True, text=True)
        cpu_lines = [ln for ln in r.stdout.splitlines() if ln and
                     not ln.startswith("[")]
        same = sum(a == b for a, b in zip(code_in, cpu_lines))
        rate = same / max(len(code_in), len(cpu_lines), 1)
        log(f"SAM agreement device vs CPU engine: {same}/{len(code_in)} "
            f"records = {rate:.3f}")
        return rate
    except Exception as e:  # noqa: BLE001
        log(f"sam agreement failed ({e})")
        return 0.0
    finally:
        os.unlink(path)


def main():
    import jax

    from lamsa_tpu.device import enable_compile_cache, use_device_path
    enable_compile_cache()
    if not use_device_path():
        raise SystemExit("bench.py measures the GPU path; JAX found "
                         f"no GPU (platform {jax.default_backend()!r})")
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"device: {device}")
    genome, ref, idx, cfg, reads = build_world()
    log(f"world: {GENOME_LEN/1e6:.1f} Mb genome, {len(idx.keys)} kmers, "
        f"{N_READS} reads {READ_LEN}")

    chain = bench_kernel()
    reads_per_s, e2e_reps, e2e_spread, _e2e_raw, st, dev_out = \
        bench_e2e(ref, idx, cfg, reads)
    agreement = sam_agreement(ref, idx, cfg, reads, dev_out)
    cpu_rps = cpu_baseline()

    # 10 kb working point (BASELINE.json primary metric context);
    # best-effort — never allowed to break the primary metric line.
    # Same warm-until-stable + median-of-5 treatment as e2e.
    rps10, recall10, reps10, spread10, _raw10 = 0.0, 0.0, [], 0.0, 0.0
    try:
        from lamsa_tpu import sim
        rng10 = np.random.default_rng(SEED + 1)
        reads10 = sim.simulate_reads(rng10, genome, 768,
                                     read_len=(9000, 11000), sub=0.02,
                                     ins=0.04, dele=0.04, sv_fraction=0.15)
        from lamsa_tpu.eval import evaluate
        from lamsa_tpu.pipeline.aln import Aligner, align_reads
        a10 = Aligner(ref, idx, cfg)
        a10.align_batch(reads10[:256])      # warm the 16k-bucket sigs
        box10 = {}

        def run10():                        # batch 256 for long reads
            t0 = time.time()
            box10["out"] = list(align_reads(
                ref, idx, reads10[256:], cfg,
                batch_size=256, aligner=a10))
            return (len(reads10) - 256) / (time.time() - t0)

        rps10, reps10, spread10, _raw10 = _stable_reps(run10, 5, "10kb")
        st10 = evaluate(box10["out"], reads10[256:])
        recall10 = st10.part_recall
        log(f"10kb: median {rps10:.1f} reads/s (spread {spread10:.2f}); "
            f"{st10.summary()}")
    except Exception as e:  # noqa: BLE001
        log(f"10kb section failed ({e}); continuing")

    # harsh CLR error profile (SURVEY.md section 1: real PacBio CLR is
    # ~10-15%+ total error) — recall must hold without approximate
    # seeding because chain density verifies (config.py seeding note)
    recall15, bp_acc = 0.0, 0.0
    try:
        from lamsa_tpu import sim
        from lamsa_tpu.eval import evaluate
        from lamsa_tpu.pipeline.aln import Aligner
        rngh = np.random.default_rng(SEED + 2)
        harsh = sim.simulate_reads(rngh, genome, 64, read_len=READ_LEN,
                                   sub=0.05, ins=0.06, dele=0.04,
                                   sv_fraction=0.35)
        ah = Aligner(ref, idx, cfg)
        sth = evaluate(ah.align_batch(harsh), harsh)
        recall15, bp_acc = sth.part_recall, sth.bp_acc_20
        log(f"15%-error profile (sub=0.05 ins=0.06 del=0.04): "
            f"{sth.summary()}")
    except Exception as e:  # noqa: BLE001
        log(f"harsh-error section failed ({e}); continuing")

    result = {
        "metric": "e2e_reads_per_s_per_chip",
        "value": round(reads_per_s, 2),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / cpu_rps, 2) if cpu_rps else 0.0,
        "device": device,
        "banded_dp_gcells_per_s": {f"{M}x{W}": round(g, 3)
                                   for (M, W), (_ms, g) in chain.items()},
        "banded_dp_ms_per_chunk": {f"{M}x{W}": round(ms, 3)
                                   for (M, W), (ms, _g) in chain.items()},
        "e2e_reps": [round(r, 1) for r in e2e_reps],
        "e2e_spread": round(e2e_spread, 3),      # trimmed (middle n-2)
        "e2e_spread_raw": round(_e2e_raw, 3),
        "part_recall": round(st.part_recall, 4),
        "read_accuracy": round(st.read_accuracy, 4),
        "sam_agreement_device_vs_cpu_engine": round(agreement, 4),
        "cpu_engine_reads_per_s": round(cpu_rps, 2),
        "reads_per_s_10kb": round(rps10, 2),
        "reads_per_s_10kb_reps": [round(r, 1) for r in reps10],
        "spread_10kb": round(spread10, 3),       # trimmed (middle n-2)
        "spread_10kb_raw": round(_raw10, 3),
        "part_recall_10kb": round(recall10, 4),
        "part_recall_15pct_err": round(recall15, 4),
        "sv_breakpoint_acc_20bp": round(bp_acc, 4),
        "baseline_note": "reference LAMSA binary unavailable (empty "
                         "mount); baseline = this framework's CPU engine "
                         "on the same workload",
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
