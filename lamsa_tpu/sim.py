"""Read / genome simulator with ground truth.

The reference repo bundled toy test reads (SURVEY.md section 4); that
bundle is unavailable here (empty mount, SURVEY.md section 0), so this
module generates the equivalent: simulated genomes, error-bearing long
reads (PacBio-CLR / ONT-style rates), and SV-spanning reads (deletion,
insertion, inversion, duplication, translocation) with machine-readable
truth for accuracy evaluation — the same external-validation style
(simulate + compare to truth) the reference's paper used.

Truth encoding: read names are ``simread_<n>|<part>;<part>;...`` where
each part is ``ref:start-end:strand:qstart-qend`` in 0-based
half-open concatenated-per-sequence coordinates.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lamsa_tpu.io.fasta import BASES, FastxRecord

_BASE_IDX = np.arange(4)


def random_genome(rng: np.random.Generator, length: int,
                  n_seqs: int = 1, gc: float = 0.5) -> list[FastxRecord]:
    """Random genome with roughly uniform composition (optionally GC-biased)."""
    p_at = (1.0 - gc) / 2
    p_gc = gc / 2
    probs = np.array([p_at, p_gc, p_gc, p_at])
    out = []
    per = length // n_seqs
    base_bytes = np.frombuffer(b"ACGT", np.uint8)
    for i in range(n_seqs):
        codes = rng.choice(_BASE_IDX, size=per, p=probs)
        seq = base_bytes[codes].tobytes().decode()
        out.append(FastxRecord(name=f"chr{i + 1}", seq=seq))
    return out


def _revcomp(seq: str) -> str:
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    return "".join(comp[c] for c in reversed(seq))


def _mutate_codes(rng, codes, div, indel_frac=0.1):
    """Diverge a code array by rate `div`: mostly substitutions (to a
    different base), a small share of 1-3 bp indels."""
    out = codes.copy()
    n_mut = rng.binomial(len(out), div * (1 - indel_frac))
    if n_mut:
        pos = rng.choice(len(out), size=n_mut, replace=False)
        out[pos] = (out[pos] + rng.integers(1, 4, n_mut)) % 4
    pieces, prev = [], 0
    for _ in range(rng.binomial(len(out), div * indel_frac)):
        p = int(rng.integers(prev, len(out))) if prev < len(out) else None
        if p is None:
            break
        ln = int(rng.integers(1, 4))
        if rng.random() < 0.5:
            pieces.append(out[prev:p])                       # deletion
            prev = min(p + ln, len(out))
        else:
            pieces.append(out[prev:p])                       # insertion
            pieces.append(rng.integers(0, 4, ln).astype(out.dtype))
            prev = p
    pieces.append(out[prev:])
    return np.concatenate(pieces)


def repeat_genome(rng: np.random.Generator, length: int, *,
                  tandem_frac: float = 0.12, family_frac: float = 0.28,
                  segdup_frac: float = 0.10,
                  name: str = "chr1") -> list[FastxRecord]:
    """Repeat-realistic synthetic genome (~50% repetitive — the real-
    genome structure classes that stress chain selection, MAPQ, and
    hit budgeting, SURVEY.md sections 4/6):
      * tandem arrays: 50-2000 bp units repeated back-to-back, copies
        diverged 0.5-8%;
      * dispersed families: 300-5000 bp consensus planted as many
        copies at 2-15% divergence, either strand, genome-wide;
      * segmental duplications: 10-50 kb blocks copied once at 1-5%
        divergence.
    The remainder stays unique random sequence. Placement never
    overlaps another planted feature (unique background only)."""
    codes = rng.integers(0, 4, length).astype(np.uint8)
    occupied = np.zeros(length, bool)
    # bounded placement: every attempt (successful or not) consumes a
    # try so a crowded genome can never spin forever looking for a
    # free window (small genomes may simply end a little below the
    # nominal repeat fraction)
    tries = [length // 1000 + 300]

    def place(piece):
        for _ in range(50):
            tries[0] -= 1
            if tries[0] <= 0:
                return False
            p = int(rng.integers(0, max(length - len(piece), 1)))
            if not occupied[p:p + len(piece)].any():
                codes[p:p + len(piece)] = piece
                occupied[p:p + len(piece)] = True
                return True
        return False

    budget = int(length * tandem_frac)
    while budget > 0 and tries[0] > 0:
        unit = rng.integers(0, 4, int(rng.integers(50, 2001))) \
            .astype(np.uint8)
        n_cp = int(rng.integers(3, 31))
        arr = [unit]
        for _ in range(n_cp - 1):
            arr.append(_mutate_codes(
                rng, unit, float(rng.uniform(0.005, 0.08))))
        block = np.concatenate(arr)[:max(budget, len(unit) * 2)]
        if place(block):
            budget -= len(block)

    budget = int(length * family_frac)
    while budget > 0 and tries[0] > 0:
        cons = rng.integers(0, 4, int(rng.integers(300, 5001))) \
            .astype(np.uint8)
        n_cp = int(rng.integers(5, 60))
        for _ in range(n_cp):
            if budget <= 0:
                break
            cp = _mutate_codes(rng, cons,
                               float(rng.uniform(0.02, 0.15)))
            if rng.random() < 0.5:
                cp = np.ascontiguousarray((3 - cp)[::-1])    # revcomp
            if place(cp):
                budget -= len(cp)

    budget = int(length * segdup_frac)
    max_seg = max(min(50_000, length // 30), 11_000)
    while budget > 0 and tries[0] > 0:
        ln = int(rng.integers(10_000, max_seg + 1))
        src = int(rng.integers(0, length - ln))
        cp = _mutate_codes(rng, codes[src:src + ln],
                           float(rng.uniform(0.01, 0.05)))
        if place(cp):
            budget -= len(cp)

    base_bytes = np.frombuffer(b"ACGT", np.uint8)
    return [FastxRecord(name=name, seq=base_bytes[codes].tobytes()
                        .decode())]


def _mutate(rng: np.random.Generator, seq: str, sub: float, ins: float,
            dele: float):
    """Apply a PacBio/ONT-style error model to a perfect read.

    Returns (mutated_seq, qmap) where qmap[i] is the mutated-read
    position of perfect-read position i (len(seq) + 1 entries; deleted
    bases map to the next surviving position) — so truth part
    boundaries can be stated exactly in final-read coordinates.
    Insertions between perfect bases i and i+1 attribute to the left
    side (emitted before qmap[i + 1] is recorded)."""
    out = []
    qmap = np.zeros(len(seq) + 1, np.int64)
    for i, ch in enumerate(seq):
        qmap[i] = len(out)
        r = rng.random()
        if r < dele:
            continue
        if r < dele + sub:
            out.append(BASES[int(rng.integers(4))])
        else:
            out.append(ch)
        while rng.random() < ins:
            out.append(BASES[int(rng.integers(4))])
    qmap[len(seq)] = len(out)
    return "".join(out), qmap


@dataclasses.dataclass
class TruthPart:
    ref_name: str
    ref_start: int
    ref_end: int     # half-open
    strand: str      # '+'/'-'
    q_start: int     # position in the final (error-free) read
    q_end: int

    def encode(self) -> str:
        return (f"{self.ref_name}:{self.ref_start}-{self.ref_end}:"
                f"{self.strand}:{self.q_start}-{self.q_end}")

    @classmethod
    def decode(cls, s: str) -> "TruthPart":
        ref, span, strand, qspan = s.rsplit(":", 3)
        rs, re_ = span.split("-")
        qs, qe = qspan.split("-")
        return cls(ref, int(rs), int(re_), strand, int(qs), int(qe))


def parse_truth(read_name: str) -> list[TruthPart]:
    _, parts = read_name.split("|", 1)
    return [TruthPart.decode(p) for p in parts.split(";")]


def simulate_reads(rng: np.random.Generator, genome: list[FastxRecord],
                   n_reads: int, read_len: tuple[int, int] = (1000, 5000),
                   sub: float = 0.01, ins: float = 0.05, dele: float = 0.04,
                   sv_fraction: float = 0.0,
                   name_prefix: str = "simread") -> list[FastxRecord]:
    """Simulate long reads; a fraction carry one SV (split reads)."""
    reads = []
    for n in range(n_reads):
        want_sv = rng.random() < sv_fraction
        L = int(rng.integers(read_len[0], read_len[1] + 1))
        if want_sv:
            perfect, parts = _simulate_sv_read(rng, genome, L)
        else:
            perfect, parts = _simulate_linear_read(rng, genome, L)
        seq, qmap = _mutate(rng, perfect, sub, ins, dele)
        # truth q intervals in FINAL read coordinates (the error model
        # shifts positions; breakpoint accuracy needs exact truth)
        parts = [dataclasses.replace(p, q_start=int(qmap[p.q_start]),
                                     q_end=int(qmap[p.q_end]))
                 for p in parts]
        name = f"{name_prefix}_{n}|" + ";".join(p.encode() for p in parts)
        reads.append(FastxRecord(name=name, seq=seq))
    return reads


def _pick_window(rng, genome, L):
    lens = np.array([len(g.seq) for g in genome], dtype=np.float64)
    si = int(rng.choice(len(genome), p=lens / lens.sum()))
    g = genome[si]
    if len(g.seq) <= L:
        return si, 0, len(g.seq)
    start = int(rng.integers(0, len(g.seq) - L))
    return si, start, start + L


def _simulate_linear_read(rng, genome, L):
    si, s, e = _pick_window(rng, genome, L)
    g = genome[si]
    frag = g.seq[s:e]
    strand = "+" if rng.random() < 0.5 else "-"
    if strand == "-":
        frag = _revcomp(frag)
    part = TruthPart(g.name, s, e, strand, 0, len(frag))
    return frag, [part]


def _simulate_sv_read(rng, genome, L):
    """Read spanning one SV: the read is two (or three) parts whose
    reference mappings are discontinuous — exactly the split-read cases
    the reference classifies (SURVEY.md section 1 stage 2)."""
    kind = rng.choice(["deletion", "insertion", "inversion",
                       "duplication", "translocation"])
    half = L // 2
    si, s, _ = _pick_window(rng, genome, L * 3 + 1000)
    g = genome[si]

    if kind == "deletion":
        # read = [s, s+half) ++ [s+half+D, s+half+D+half)
        D = int(rng.integers(50, 2000))
        a = g.seq[s:s + half]
        b = g.seq[s + half + D:s + half + D + half]
        parts = [TruthPart(g.name, s, s + half, "+", 0, half),
                 TruthPart(g.name, s + half + D, s + half + D + len(b), "+",
                           half, half + len(b))]
        return a + b, parts

    if kind == "insertion":
        # novel sequence inserted mid-read
        I = int(rng.integers(50, min(1000, max(51, L // 2))))
        novel = "".join(BASES[int(rng.integers(4))] for _ in range(I))
        a = g.seq[s:s + half]
        b = g.seq[s + half:s + L]
        parts = [TruthPart(g.name, s, s + half, "+", 0, half),
                 TruthPart(g.name, s + half, s + L, "+",
                           half + I, half + I + len(b))]
        return a + novel + b, parts

    if kind == "inversion":
        # middle third inverted
        third = L // 3
        a = g.seq[s:s + third]
        m = _revcomp(g.seq[s + third:s + 2 * third])
        b = g.seq[s + 2 * third:s + L]
        parts = [
            TruthPart(g.name, s, s + third, "+", 0, third),
            TruthPart(g.name, s + third, s + 2 * third, "-",
                      third, 2 * third),
            TruthPart(g.name, s + 2 * third, s + L, "+", 2 * third,
                      2 * third + len(b)),
        ]
        return a + m + b, parts

    if kind == "duplication":
        # tandem duplication: segment appears twice in the read
        seg = g.seq[s:s + half]
        b = g.seq[s + half:s + L]
        parts = [
            TruthPart(g.name, s, s + half, "+", 0, half),
            TruthPart(g.name, s, s + half, "+", half, 2 * half),
            TruthPart(g.name, s + half, s + L, "+", 2 * half,
                      2 * half + len(b)),
        ]
        return seg + seg + b, parts

    # translocation: second half from a far-away locus (or other seq);
    # best-effort distance — small toy genomes may not allow 10*L.
    sj, s2, _ = _pick_window(rng, genome, L)
    g2 = genome[sj]
    for _ in range(20):
        if g2.name != g.name or abs(s2 - s) >= 10 * L:
            break
        sj, s2, _ = _pick_window(rng, genome, L)
        g2 = genome[sj]
    a = g.seq[s:s + half]
    b = g2.seq[s2:s2 + half]
    parts = [TruthPart(g.name, s, s + half, "+", 0, half),
             TruthPart(g2.name, s2, s2 + len(b), "+", half, half + len(b))]
    return a + b, parts


# ------------------------------------------------- DP engine instances

def _edit(rng, t, sub, ins, dele):
    """Copy of code array t with per-base substitution, deletion and
    insertion (one random base after the position) rates."""
    r = rng.random(len(t))
    out = np.where(r < sub, (t + rng.integers(1, 4, len(t))) % 4, t)
    keep = (r < sub) | (r >= sub + dele)
    ins_at = np.flatnonzero(rng.random(len(t)) < ins)
    vals = np.concatenate([out[keep], rng.integers(0, 4, len(ins_at))])
    keys = np.concatenate([2 * np.flatnonzero(keep), 2 * ins_at + 1])
    return vals[np.argsort(keys, kind="stable")].astype(np.uint8)


def _indel_ladder(rng, t, period=8):
    """t with, in every period-base block, its first base deleted and
    one random base inserted mid-block: one deletion per block that the
    aligner cannot merge with the insertion into mismatches."""
    out, h = [], period // 2
    for k in range(0, len(t), period):
        blk = t[k:k + period]
        out += [blk[1:h], rng.integers(0, 4, 1).astype(np.uint8), blk[h:]]
    return np.concatenate(out).astype(np.uint8)


def dp_instances(rng: np.random.Generator, M: int, W: int, count: int):
    """`count` DP instances whose first-fit bucket (pipeline/extend.py
    BUCKETS) is (M, W), as descriptors over a flat read array and a
    reference array — the form the aligner hands its DpBatcher.

    Globals are mutated copies of a reference segment; some carry one
    long deletion or insertion (the drift that sends a gap to a W=256
    bucket, and D runs too long for the compact wire's narrow events),
    and in the widest bucket some carry a deletion every 8 bases (more
    D events than the wire holds). Extensions (where one fits first in
    this bucket) follow the aligner's n <= m + EXT_MARGIN rule, some
    with a random tail. Queries are stored forward or reverse-
    complemented and targets forward or reversed, covering every
    descriptor case.

    Returns {"flat", "ref": uint8 codes, "items": [(kind, m, n, qd, td)]}
    with qd = (q_base, q_step, q_comp) and td = (t_base, t_step)."""
    from lamsa_tpu.pipeline.aln import _EXT_CAP
    from lamsa_tpu.pipeline.extend import BUCKETS, EXT_MARGIN, _bucket_fits

    def first_fit(kind, m, n):
        return next((b for b in BUCKETS if _bucket_fits(kind, m, n, *b)),
                    None)

    m_lo = max([b[0] for b in BUCKETS if b[0] < M], default=0) + 1
    m_ext = min(M, _EXT_CAP)
    can_extend = m_lo <= m_ext and any(
        first_fit("extend", m, m + d) == (M, W)
        for m in (m_lo, m_ext) for d in (0, EXT_MARGIN))
    # a drift-free global of this length fits an earlier W=128 bucket:
    # every global here carries one long indel
    drift_only = first_fit("global", M, M) != (M, W)
    ref_len = max(1 << 16, 4 * count * (M + 256))
    ref = rng.integers(0, 4, ref_len).astype(np.uint8)
    flat, items, pos = [], [], 0
    while len(items) < count:
        kind = "extend" if can_extend and rng.random() < 0.4 else "global"
        style = rng.random()
        ladder = kind == "global" and M > 2048 and style < 0.2
        m0 = int(rng.integers(max(m_lo, 3 * M // 4) if ladder else m_lo,
                              (m_ext if kind == "extend" else M) + 1))
        n = m0 + (int(rng.integers(0, EXT_MARGIN + 1)) if kind == "extend"
                  else 0)
        t0 = int(rng.integers(0, ref_len - n - 256))
        t_rev = rng.random() < 0.5
        t = ref[t0:t0 + n][::-1] if t_rev else ref[t0:t0 + n]
        if kind == "extend":
            q = _edit(rng, t[:m0], 0.03, 0.02, 0.02)
            if rng.random() < 0.3:          # diverged tail: clip/zdrop
                cut = int(rng.integers(len(q) // 2, len(q) + 1))
                q[cut:] = rng.integers(0, 4, len(q) - cut)
        else:
            if ladder:                      # D events past the budget
                q = _indel_ladder(rng, t)
            else:
                q = _edit(rng, t, 0.03, 0.02, 0.02)
                if drift_only or style > 0.7:   # one long indel
                    ln = int(rng.integers(81 if drift_only else 31, 190))
                    at = int(rng.integers(0, max(1, len(q) - ln)))
                    if rng.random() < 0.6:
                        q = np.concatenate([q[:at], q[at + ln:]])
                    else:
                        q = np.concatenate(
                            [q[:at], rng.integers(0, 4, ln).astype(np.uint8),
                             q[at:]])
        m = len(q)
        if m == 0 or first_fit(kind, m, n) != (M, W):
            continue
        q_rc = rng.random() < 0.5
        if q_rc:
            flat.append(np.where(q < 4, 3 - q, q)[::-1])
            qd = (pos + m - 1, -1, 1)
        else:
            flat.append(q)
            qd = (pos, 1, 0)
        pos += m
        td = (t0 + n - 1, -1) if t_rev else (t0, 1)
        items.append((kind, m, n, qd, td))
    return {"flat": np.concatenate(flat).astype(np.uint8), "ref": ref,
            "items": items}


def enqueue_dp_instances(batcher, inst, bonus: int = 5) -> list[int]:
    """Add dp_instances() items to a DpBatcher; returns their handles."""
    handles = []
    for kind, m, n, qd, td in inst["items"]:
        if kind == "global":
            handles.append(batcher.add_global_desc(m, n, qd, td))
        else:
            handles.append(batcher.add_extend_desc(m, n, bonus, qd, td))
    return handles
