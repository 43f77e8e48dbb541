"""Config-5-shaped soak: sustained whole-genome alignment at >= 50k
reads through the real CLI (BASELINE.json config 5 is "1M mixed
reads, data-parallel streaming" — this is a single-host slice of it).

Three legs, all against the cached config-4 world built by
tools/wholegenome_bench.py (3.1 Gb genome + FM index in --workdir):

  A. Uninterrupted run of --reads 9-11 kb reads via
     ``lamsa aln -o out.sam --stats stats.jsonl``; a poller samples the
     process RSS and the .progress cursor. Report reads/s per
     ~1k-read window and RSS over time; both must stay flat (+-10%)
     after the first (compile-warmup) window.
  B. The same input as two shards: shard 0 is SIGKILLed mid-run and
     resumed with ``--resume``; shard 1 runs clean; ``lamsa merge``
     interleaves them. The merged SAM must equal leg A's record-for-
     record (headers modulo the @PG command line / @CO shard tag).
  C. (within B) the killed+resumed shard-0 file must be byte-identical
     to what an uninterrupted shard-0 run writes — proven indirectly
     through the merge equality; the unit-scale byte proof is
     tests/test_cli.py::test_aln_resume_after_kill.

Reads are cached under --workdir/soak so re-runs skip generation. Run:
  python tools/soak_bench.py [--reads 50000] [--batch 256] [--leg A|B|all]
Prints one JSON line with the sustained curve + verdicts.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import numpy as np

SEED = 20260821


def log(msg):
    print(f"[soak] {msg}", file=sys.stderr, flush=True)


def ensure_reads(workdir, n_reads):
    """Simulate (once, cached) n_reads 9-11 kb reads off the cached
    3.1 Gb genome, written as FASTQ for the CLI."""
    soak = os.path.join(workdir, "soak")
    os.makedirs(soak, exist_ok=True)
    fq = os.path.join(soak, f"reads_{n_reads}.fq")
    if os.path.exists(fq + ".done"):
        log(f"reads cached: {fq}")
        return fq
    from wholegenome_bench import sample_reads

    from lamsa_tpu.io.refpack import PackedReference
    ref = PackedReference.load(os.path.join(workdir, "index"))
    rng = np.random.default_rng(SEED)
    t0 = time.time()
    with open(fq, "w") as fh:
        done = 0
        while done < n_reads:
            chunk = sample_reads(ref, min(2000, n_reads - done), rng)
            for r in chunk:
                q = r.qual or "I" * len(r.seq)   # sim emits qual=None
                fh.write(f"@{r.name}\n{r.seq}\n+\n{q}\n")
            done += len(chunk)
            log(f"simulated {done}/{n_reads} reads "
                f"({time.time() - t0:.0f}s)")
    open(fq + ".done", "w").close()
    return fq


def make_rundir(workdir, name, fq):
    d = os.path.join(workdir, "soak", name)
    os.makedirs(d, exist_ok=True)
    for link, target in (("genome.fa.lti", os.path.join(workdir, "index")),
                         ("reads.fq", fq)):
        p = os.path.join(d, link)
        if not os.path.exists(p):
            os.symlink(target, p)
    return d


def run_cli(cwd, out_name, extra, kill_at=None, rss_log=None,
            resume=False):
    """Run `lamsa aln` as a subprocess; optionally SIGKILL it once its
    .progress cursor passes kill_at reads; optionally append (t, rss_kb,
    reads_done) samples to rss_log. Returns the exit code."""
    argv = [sys.executable, "-m", "lamsa_tpu.cli", "aln",
            "-o", out_name, "--stats", "stats.jsonl"] + extra + \
        (["--resume"] if resume else []) + ["genome.fa", "reads.fq"]
    # prepend the repo, keeping any PYTHONPATH the caller set; children
    # run one at a time (one process per card)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    with open(os.path.join(cwd, "cli.log"), "a") as lg:
        proc = subprocess.Popen(argv, cwd=cwd, env=env, stdout=lg,
                                stderr=lg)
    prog = os.path.join(cwd, out_name + ".progress")
    killed = False
    while proc.poll() is None:
        time.sleep(2.0)
        reads_done = 0
        try:
            with open(prog) as fh:
                reads_done = int(fh.read().strip() or 0)
        except (OSError, ValueError):
            pass
        try:
            with open(f"/proc/{proc.pid}/status") as fh:
                rss = next((int(l.split()[1]) for l in fh
                            if l.startswith("VmRSS")), 0)
        except OSError:
            rss = 0
        if rss_log is not None:
            with open(rss_log, "a") as fh:
                fh.write(f"{time.time() - t0:.1f}\t{rss}\t"
                         f"{reads_done}\n")
        if kill_at is not None and not killed and reads_done >= kill_at:
            log(f"SIGKILL at {reads_done} reads (cursor)")
            proc.kill()         # exact PID, never a pattern
            killed = True
    rc = proc.wait()
    return -9 if killed else rc


def window_curve(stats_path, win=1000):
    """Per-~win-read throughput from the per-batch --stats JSONL."""
    pts = []
    with open(stats_path) as fh:
        for ln in fh:
            try:
                s = json.loads(ln)
                pts.append((s["reads_done"], s["wall_total_s"]))
            except (ValueError, KeyError):
                continue
    curve = []
    last_r, last_w = 0, 0.0
    for r, w in pts:
        if r - last_r >= win:
            curve.append(round((r - last_r) / (w - last_w), 1))
            last_r, last_w = r, w
    return curve


def flatness(vals):
    """(min, max, median, max deviation from median) over vals."""
    if not vals:
        return None
    med = float(np.median(vals))
    dev = max(abs(v - med) / med for v in vals)
    return {"min": min(vals), "max": max(vals),
            "median": round(med, 1), "max_dev": round(dev, 3)}


def strip_volatile(path):
    """SAM lines minus the @PG command line and @CO shard tag (the only
    text that legitimately differs between a plain run and a
    shard+merge of the same input)."""
    with open(path) as fh:
        return [ln for ln in fh
                if not (ln.startswith("@PG") or
                        ln.startswith("@CO\tlamsa_tpu_shard:"))]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=os.path.join(REPO, ".bench_work"))
    ap.add_argument("--reads", type=int, default=50000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--leg", default="all", choices=["A", "B", "all"])
    ap.add_argument("--kill-frac", type=float, default=0.5)
    args = ap.parse_args()

    fq = ensure_reads(args.workdir, args.reads)
    extra = ["--batch-reads", str(args.batch)]
    result = {"metric": "soak_50k", "n_reads": args.reads,
              "batch": args.batch}

    if args.leg in ("A", "all"):
        dA = make_rundir(args.workdir, "runA", fq)
        rss_log = os.path.join(dA, "rss.tsv")
        for f in ("out.sam", "out.sam.progress", "stats.jsonl",
                  "rss.tsv", "cli.log"):
            p = os.path.join(dA, f)
            if os.path.exists(p):
                os.unlink(p)
        t0 = time.time()
        rc = run_cli(dA, "out.sam", extra, rss_log=rss_log)
        wall = time.time() - t0
        assert rc == 0, f"leg A failed rc={rc} (see {dA}/cli.log)"
        curve = window_curve(os.path.join(dA, "stats.jsonl"))
        rss = np.loadtxt(rss_log, usecols=1) / 1024.0   # MB
        n4 = max(1, len(rss) // 4)
        result["leg_A"] = {
            "wall_s": round(wall, 1),
            "reads_per_s_overall": round(args.reads / wall, 1),
            "window_curve": curve,
            "steady": flatness(curve[1:]),      # window 0 = compile warmup
            "rss_peak_mb": round(float(rss.max()), 1),
            "rss_first_quarter_mb": round(float(np.median(rss[:n4])), 1),
            "rss_last_quarter_mb": round(float(np.median(rss[-n4:])), 1),
        }
        st = result["leg_A"]["steady"]
        result["leg_A"]["throughput_flat_10pct"] = \
            bool(st and st["max_dev"] <= 0.10)
        result["leg_A"]["rss_flat_10pct"] = bool(
            result["leg_A"]["rss_last_quarter_mb"] <=
            1.10 * result["leg_A"]["rss_first_quarter_mb"])
        log(f"leg A: {result['leg_A']['reads_per_s_overall']} reads/s, "
            f"steady {st}, RSS peak "
            f"{result['leg_A']['rss_peak_mb']} MB")

    if args.leg in ("B", "all"):
        shard_extra = [extra + ["--num-shards", "2", "--shard-id",
                                str(i)] for i in (0, 1)]
        dB = make_rundir(args.workdir, "runB", fq)
        for f in ("s0.sam", "s0.sam.progress", "s1.sam",
                  "s1.sam.progress", "merged.sam", "stats.jsonl",
                  "cli.log"):
            p = os.path.join(dB, f)
            if os.path.exists(p):
                os.unlink(p)
        kill_at = int(args.reads / 2 * args.kill_frac)
        rc = run_cli(dB, "s0.sam", shard_extra[0], kill_at=kill_at)
        log(f"shard 0 killed (rc={rc}); resuming")
        rc = run_cli(dB, "s0.sam", shard_extra[0], resume=True)
        assert rc == 0, f"shard-0 resume failed rc={rc}"
        rc = run_cli(dB, "s1.sam", shard_extra[1])
        assert rc == 0, f"shard 1 failed rc={rc}"
        with open(os.path.join(dB, "cli.log"), "a") as lg:
            rc = subprocess.call(
                [sys.executable, "-m", "lamsa_tpu.cli", "merge", "-o",
                 "merged.sam", "s0.sam", "s1.sam"], cwd=dB,
                env=dict(os.environ, PYTHONPATH=REPO + os.pathsep +
                         os.environ.get("PYTHONPATH", "")), stdout=lg,
                stderr=lg)
        assert rc == 0, f"merge failed rc={rc}"
        dA = os.path.join(args.workdir, "soak", "runA")
        same = strip_volatile(os.path.join(dA, "out.sam")) == \
            strip_volatile(os.path.join(dB, "merged.sam"))
        result["leg_B"] = {"kill_at_reads": kill_at,
                           "resume_merge_equals_plain_run": bool(same)}
        log(f"leg B: kill+resume+merge == plain run: {same}")

    print(json.dumps(result))


if __name__ == "__main__":
    main()
