"""Smoke run of the aligner on one NVIDIA GPU: compile, check, align.

    python chip_smoke.py             # phases a-d on one card
    python chip_smoke.py --cards 4   # phase e alone, on four cards

One process drives the card(s). Phases:
  a  device: JAX's devices, and the card's name and power limit;
  b  compile: the fused DP chain of every (M, W) bucket at its chunk
     size, and the seeding jits at phase d's shapes — compile seconds
     and memory_analysis() per signature;
  c  chain vs reference: seeded globals and extensions per bucket
     through the device chain, against the CPU engine (XLA DP + native
     traceback on this process's CPU device): 0 mismatches, including
     instances that overflow the compact wire (host recompute) and the
     wide-event 5120-row bucket;
  d  end to end through `lamsa index` / `lamsa aln` in this process on
     a config-1 world (4.6 Mb genome, 512 x 1-5 kb CLR-like reads) and
     a chr20-scale world (64 Mb genome, FM index, 256 x 9-11 kb reads):
     reads/s and stage times (smoke figures, not benchmark numbers),
     accuracy against the simulated truth, SAM byte-identical to the
     CPU engine, and 0 compiles in a second pass;
  e  (--cards 4) `aln -d 4` on the config-1 world against the one-card
     SAM, byte for byte.

Every failed phase makes the exit code non-zero. Platforms are pinned
to "cuda,cpu"; without a GPU the script stops in phase a and prints no
result. The last stdout line is one JSON object:
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import bench  # noqa: E402
from lamsa_tpu import sim  # noqa: E402

BACKEND_COMPILE = "/jax/core/compile/backend_compile_duration"
BIG_GENOME = 64_000_000          # chr20 scale
BIG_READS = 256
BIG_SEED = 20260818


def log(msg):
    print(msg, flush=True)


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def check_device(devices, cards: int):
    """Refuse anything but `cards` or more GPUs (lamsa_tpu.device is
    the one place that tells a GPU from the CPU)."""
    from lamsa_tpu.device import use_device_path
    if not use_device_path():
        raise Failed(f"need a GPU, JAX's default device is "
                     f"{devices[0].platform!r}")
    if len(devices) < cards:
        raise Failed(f"need {cards} GPUs, JAX sees {len(devices)}")


class CompileCounter:
    """Counts XLA backend compiles while enabled (jax.monitoring)."""

    def __init__(self):
        import jax
        self.n = 0
        self.on = False
        jax.monitoring.register_event_duration_secs_listener(self._event)

    def _event(self, event, duration, **kwargs):
        if self.on and event == BACKEND_COMPILE:
            self.n += 1


def _mib(x):
    return f"{x / 2**20:.1f} MiB"


def memory_line(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis: none"
    return (f"args {_mib(ma.argument_size_in_bytes)}, "
            f"out {_mib(ma.output_size_in_bytes)}, "
            f"temp {_mib(ma.temp_size_in_bytes)}, "
            f"code {_mib(ma.generated_code_size_in_bytes)}")


# ------------------------------------------------------------ phase a

def phase_device(cards):
    import jax
    devices = jax.devices()
    check_device(devices, cards)
    for d in devices:
        log(f"[a] device {d.id}: platform={d.platform} kind={d.device_kind}")
    log(f"[a] cpu device for the reference engine: {jax.devices('cpu')[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log("[a] nvidia-smi name, power.limit:")
    for line in smi.splitlines():
        log(line)
    return devices


# ------------------------------------------------------------ phase b

def bucket_cases(seed=7):
    from lamsa_tpu.pipeline.extend import BUCKETS, CHUNK_BY_M
    rng = np.random.default_rng(seed)
    return {b: sim.dp_instances(rng, *b, CHUNK_BY_M[b]) for b in BUCKETS}


def _sources(case):
    import jax

    from lamsa_tpu.ops.banded_sw import pack_codes_words
    return (jax.device_put(pack_codes_words(case["flat"])),
            jax.device_put(pack_codes_words(case["ref"])))


def phase_compile_chain(cases, scores):
    import jax
    import jax.numpy as jnp

    from lamsa_tpu.ops.banded_sw import _dp_tb_fused_gather
    from lamsa_tpu.pipeline.extend import CHUNK_BY_M
    total = 0.0
    for (M, W), case in cases.items():
        flat_dev, ref_dev = _sources(case)
        desc = jax.ShapeDtypeStruct((CHUNK_BY_M[(M, W)], 4), jnp.int32)
        t0 = time.perf_counter()
        compiled = _dp_tb_fused_gather.lower(
            flat_dev, ref_dev, desc, M=M, W=W, match=scores.match,
            mismatch=scores.mismatch, gapo=scores.gap_open,
            gape=scores.gap_ext, zdrop=scores.zdrop).compile()
        dt = time.perf_counter() - t0
        total += dt
        log(f"[b] chain ({M}, {W}) B={CHUNK_BY_M[(M, W)]}: compile "
            f"{dt:.1f}s; {memory_line(compiled)}")
    log(f"[b] all {len(cases)} buckets compiled in {total:.1f}s")


def seeding_signatures(aligner, reads):
    """(L, Bp) of every seeding call align_batch makes for `reads`
    (one batch), mirroring Aligner._seed_and_chain's padding."""
    cfg = aligner.config
    groups = {}
    for r in reads:
        L = aligner._bucket_len(max(len(r.seq), cfg.kmer + 1))
        groups[L] = groups.get(L, 0) + 1
    return sorted((L, max(8, 1 << (n - 1).bit_length()))
                  for L, n in groups.items())


def phase_compile_seeding(name, aligner, reads):
    import jax
    import jax.numpy as jnp

    from lamsa_tpu.pipeline import aln
    cfg = aligner.config
    common = dict(k=aligner.k, cands_per_seed=cfg.max_cands_per_seed,
                  max_hits=cfg.max_hits_per_read, weight=aligner.k,
                  lookback=cfg.chain_lookback, max_dist=cfg.chain_max_dist,
                  diag_slack=cfg.chain_diag_slack)
    d = aligner._dev
    for L, Bp in seeding_signatures(aligner, reads):
        rc = jax.ShapeDtypeStruct((Bp, L), jnp.uint8)
        lens = jax.ShapeDtypeStruct((Bp,), jnp.int32)
        grid = aligner._grid(L, cfg.seed_step)
        t0 = time.perf_counter()
        if aligner.seed_backend == "fm":
            fn = "_seed_chain_packed_fm"
            lowered = aln._seed_chain_packed_fm.lower(
                rc, lens, grid, d, sa_rate=aligner.index.sa_rate,
                seg_quota=0, sub1_cands=0, sub1_k=0,
                sub1_kinds=cfg.seed_1edit_kinds, **common)
        elif "dense_starts" in d:
            fn = "_seed_chain_packed_direct"
            lowered = aln._seed_chain_packed_direct.lower(
                rc, lens, grid, d["dense_starts"], d["dense_counts"],
                d["pos16"], **common)
        else:
            fn = "_seed_chain_packed"
            lowered = aln._seed_chain_packed.lower(
                rc, lens, grid, d["keys"], d["starts"], d["counts"],
                d["positions"], **common)
        compiled = lowered.compile()
        log(f"[b] {name} seeding {fn} L={L} B={Bp}: compile "
            f"{time.perf_counter() - t0:.1f}s; {memory_line(compiled)}")


# ------------------------------------------------------------ phase c

def _run_batcher(case, scores, on_device):
    from lamsa_tpu.pipeline.extend import DpBatcher
    host = (case["flat"], case["ref"])
    b = DpBatcher(scores, host_sources=host,
                  device_sources=_sources(case) if on_device else None)
    handles = sim.enqueue_dp_instances(b, case)
    b.run()
    return [b.result(h) for h in handles]


def phase_chain_vs_cpu(cases, scores, cpu):
    import jax

    from lamsa_tpu.ops.banded_sw import compact_overflows
    total_bad = total = total_over = 0
    for (M, W), case in cases.items():
        t0 = time.perf_counter()
        dev = _run_batcher(case, scores, True)
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        with jax.default_device(cpu):
            ref = _run_batcher(case, scores, False)
        t_cpu = time.perf_counter() - t0
        bad = sum(
            (a.score, a.q_used, a.t_used) != (b.score, b.q_used, b.t_used)
            or not np.array_equal(a.cigar, b.cigar)
            for a, b in zip(dev, ref))
        over = sum(compact_overflows(r.cigar, M) for r in ref)
        n_ext = sum(it[0] == "extend" for it in case["items"])
        log(f"[c] ({M}, {W}): {len(ref)} instances ({n_ext} extensions, "
            f"{over} over the compact wire), {bad} mismatches "
            f"(device {t_dev:.1f}s incl. compile, CPU engine "
            f"{t_cpu:.1f}s)")
        total_bad += bad
        total += len(ref)
        total_over += over
    log(f"[c] total: {total} instances, {total_over} host recomputes, "
        f"{total_bad} mismatches")
    check(total_bad == 0, f"{total_bad} device/CPU mismatches")
    check(total_over > 0, "no instance exercised the overflow recompute")


# ------------------------------------------------------------ phase d

def _records(sam_path):
    """SAM record lines grouped per read, in file order."""
    groups, last = [], None
    with open(sam_path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            qname = line.split("\t", 1)[0]
            if qname != last:
                groups.append([])
                last = qname
            groups[-1].append(line.rstrip("\n"))
    return groups


def _parse(line):
    from lamsa_tpu.io.sam import SamRecord, cigar_from_string
    f = line.split("\t")
    cig = [] if f[5] == "*" else cigar_from_string(f[5])
    return SamRecord(qname=f[0], flag=int(f[1]), rname=f[2],
                     pos=int(f[3]) - 1, mapq=int(f[4]), cigar=cig,
                     seq=f[9])


def _stage_line(stats_path):
    with open(stats_path) as fh:
        snap = json.loads(fh.read().strip().splitlines()[-1])
    top = ", ".join(f"{k} {v:.2f}s" for k, v in snap["wall_s"].items()
                    if not k.startswith("dp_") or k == "dp_batch")
    return top


def run_world(name, workdir, make, index_args, counter, cpu):
    """Phase d for one world (and phase b's seeding compiles at its
    shapes)."""
    import jax

    from lamsa_tpu import cli
    from lamsa_tpu.eval import evaluate
    from lamsa_tpu.io.fasta import write_fasta, write_fastq
    genome, reads = make()
    fa = os.path.join(workdir, f"{name}.fa")
    fq = os.path.join(workdir, f"{name}.fq")
    write_fasta(fa, genome)
    write_fastq(fq, reads)
    del genome
    t0 = time.perf_counter()
    check(cli.main(["index", *index_args, fa]) == 0, f"{name}: index")
    log(f"[d] {name}: index {' '.join(index_args) or '(k-mer)'} "
        f"{time.perf_counter() - t0:.1f}s")
    phase_compile_seeding(name, _aligner_for(fa), reads)

    outs = {}
    for run in ("pass1", "pass2"):
        sam = os.path.join(workdir, f"{name}.{run}.sam")
        stats = sam + ".stats"
        counter.n, counter.on = 0, run == "pass2"
        t0 = time.perf_counter()
        rc = cli.main(["aln", "-o", sam, "--stats", stats, fa, fq])
        dt = time.perf_counter() - t0
        counter.on = False
        check(rc == 0, f"{name}: aln {run}")
        note = "incl. compiles" if run == "pass1" else \
            f"{counter.n} compiles in the window"
        log(f"[d] {name} {run}: {len(reads)} reads in {dt:.2f}s = "
            f"{len(reads) / dt:.2f} reads/s ({note}); stages: "
            f"{_stage_line(stats)}")
        outs[run] = _records(sam)
    check(counter.n == 0, f"{name}: {counter.n} compiles in pass 2")
    gpu = outs["pass2"]
    check(gpu == outs["pass1"], f"{name}: pass 1 and pass 2 SAM differ")
    check(len(gpu) == len(reads), f"{name}: {len(gpu)} read groups "
          f"for {len(reads)} reads")
    st = evaluate([[_parse(ln) for ln in g] for g in gpu], reads)
    log(f"[d] {name} accuracy: {st.summary()}")

    sam_cpu = os.path.join(workdir, f"{name}.cpu.sam")
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        check(cli.main(["aln", "-o", sam_cpu, fa, fq]) == 0,
              f"{name}: CPU engine aln")
    cpu_groups = _records(sam_cpu)
    same = sum(a == b for a, b in zip(gpu, cpu_groups))
    log(f"[d] {name} SAM vs CPU engine, all reads: {same}/{len(reads)} "
        f"reads byte-identical ({sum(len(g) for g in gpu)} records; CPU "
        f"engine {time.perf_counter() - t0:.1f}s)")
    check(same == len(reads) == len(cpu_groups),
          f"{name}: SAM differs from the CPU engine")


def config1_world():
    genome, _ref, _idx, _cfg, reads = bench.build_world()
    return genome, reads


def big_world():
    rng = np.random.default_rng(BIG_SEED)
    genome = sim.random_genome(rng, BIG_GENOME)
    reads = sim.simulate_reads(rng, genome, BIG_READS,
                               read_len=(9000, 11000), sub=0.02, ins=0.04,
                               dele=0.04, sv_fraction=0.15)
    return genome, reads


def _aligner_for(fa):
    from lamsa_tpu.cli import _index_dir
    from lamsa_tpu.config import preset
    from lamsa_tpu.index.fmindex import FmIndex
    from lamsa_tpu.index.kmer import KmerIndex
    from lamsa_tpu.io.refpack import PackedReference
    from lamsa_tpu.pipeline.aln import Aligner
    d = _index_dir(fa)
    ref = PackedReference.load(d)
    index = FmIndex.load(d) if FmIndex.exists(d) else KmerIndex.load(d)
    return Aligner(ref, index, preset("pacbio"))


# ------------------------------------------------------------ phase e

def phase_cards(workdir, cards):
    from lamsa_tpu import cli
    genome, reads = config1_world()
    fa = os.path.join(workdir, "c1.fa")
    fq = os.path.join(workdir, "c1.fq")
    from lamsa_tpu.io.fasta import write_fasta, write_fastq
    write_fasta(fa, genome)
    write_fastq(fq, reads)
    check(cli.main(["index", fa]) == 0, "index")
    outs = {}
    for n in (1, cards):
        sam = os.path.join(workdir, f"c1.d{n}.sam")
        t0 = time.perf_counter()
        check(cli.main(["aln", "-d", str(n), "-o", sam, fa, fq]) == 0,
              f"aln -d {n}")
        dt = time.perf_counter() - t0
        outs[n] = _records(sam)
        log(f"[e] aln -d {n}: {len(reads)} reads in {dt:.2f}s = "
            f"{len(reads) / dt:.2f} reads/s (incl. compiles)")
    same = sum(a == b for a, b in zip(outs[1], outs[cards]))
    log(f"[e] {cards}-card SAM vs 1-card SAM: {same}/{len(outs[1])} reads "
        f"byte-identical")
    check(same == len(outs[1]) == len(outs[cards]) == len(reads),
          f"{cards}-card SAM differs from the 1-card SAM")


# --------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4 runs only the multi-card phase e")
    args = ap.parse_args(argv)

    import jax
    # an explicit list: no card is an error, never a silent CPU run;
    # the CPU device stays available for the reference engine
    jax.config.update("jax_platforms", "cuda,cpu")
    from lamsa_tpu.device import enable_compile_cache
    log(f"compile cache: {enable_compile_cache()}")

    devices = phase_device(args.cards)
    cpu = jax.devices("cpu")[0]
    failed = []

    def phase(name, fn, *a):
        try:
            fn(*a)
        except Exception as e:  # noqa: BLE001 — report, run the rest
            traceback.print_exc()
            log(f"[{name}] FAILED: {e}")
            failed.append(name)

    with tempfile.TemporaryDirectory(prefix="lamsa_smoke_") as work:
        if args.cards > 1:
            phase("e", phase_cards, work, args.cards)
        else:
            scores = bench.scores()
            cases = bucket_cases()
            phase("b", phase_compile_chain, cases, scores)
            phase("c", phase_chain_vs_cpu, cases, scores, cpu)
            counter = CompileCounter()
            phase("d", run_world, "config1", work, config1_world, [],
                  counter, cpu)
            phase("d", run_world, "chr20", work, big_world, ["--fm"],
                  counter, cpu)

    if failed:
        log(f"FAILED phases: {', '.join(failed)}")
        return 1
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
