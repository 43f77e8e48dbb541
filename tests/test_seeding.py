"""k-mer index + on-device seeding tests."""

import numpy as np

from lamsa_tpu.index.kmer import KmerIndex, kmer_codes
from lamsa_tpu.io.fasta import encode_seq, revcomp4
from lamsa_tpu.pipeline.seeding import make_qpos_grid, seed_hits
from lamsa_tpu import sim
from lamsa_tpu.io.refpack import PackedReference
from lamsa_tpu.io.fasta import write_fasta


def codes_of(s):
    return np.frombuffer(encode_seq(s), np.uint8)


def test_kmer_codes_basic():
    keys, valid = kmer_codes(codes_of("ACGTA"), 3)
    # ACG=0b000110=6, CGT=0b011011=27, GTA=0b101100=44
    assert list(keys) == [0b000110, 0b011011, 0b101100]
    assert valid.all()
    keys, valid = kmer_codes(codes_of("ACNTA"), 3)
    assert list(valid) == [False, False, False]


def test_index_build_and_host_lookup(rng):
    ref = rng.integers(0, 4, 5000).astype(np.uint8)
    idx = KmerIndex.build(ref, 11)
    # every indexed position's key matches the ref substring
    keys, valid = kmer_codes(ref, 11)
    for ui in rng.integers(0, len(idx.keys), 50):
        k = idx.keys[ui]
        for p in idx.positions[idx.starts[ui]:idx.starts[ui]
                               + idx.counts[ui]]:
            assert keys[p] == k
    # lookup of a known substring finds its position
    p0 = 1234
    key = keys[p0]
    assert p0 in idx.lookup_host(int(key))


def test_index_caps_repetitive_kmers():
    ref = np.tile(codes_of("ACGTACGTACG"), 200)[:2000]
    idx = KmerIndex.build(ref, 8, max_hits_per_kmer=16)
    assert idx.counts.max() <= 16


def test_index_save_load(tmp_path, rng):
    ref = rng.integers(0, 4, 3000).astype(np.uint8)
    idx = KmerIndex.build(ref, 13)
    idx.save(str(tmp_path))
    idx2 = KmerIndex.load(str(tmp_path))
    assert idx2.k == 13
    for a, b in [(idx.keys, idx2.keys), (idx.starts, idx2.starts),
                 (idx.counts, idx2.counts), (idx.positions, idx2.positions)]:
        assert np.array_equal(a, b)


def _run_seed_hits(reads_codes, read_lens, idx, k, L, step=7, C=8, H=128):
    B = len(reads_codes)
    rc = np.full((B, L), 4, np.int32)
    for i, r in enumerate(reads_codes):
        rc[i, :len(r)] = r
    grid = make_qpos_grid(L, k, step)
    res = seed_hits(rc, np.asarray(read_lens, np.int32), grid,
                    idx.keys, idx.starts, idx.counts,
                    idx.positions.astype(np.uint32),
                    k=k, cands_per_seed=C, max_hits=H)
    out = {kk: np.asarray(v) for kk, v in res.items()}
    out["rpos"] = out["rpos"].astype(np.int64)
    return out


def test_seed_hits_forward_exact(rng):
    k = 11
    ref = rng.integers(0, 4, 8000).astype(np.uint8)
    idx = KmerIndex.build(ref, k)
    # read = exact slice of ref
    start = 3000
    read = ref[start:start + 200]
    res = _run_seed_hits([read], [200], idx, k, 256)
    v = res["valid"][0]
    assert v.any()
    fwd = v & (res["strand"][0] == 0)
    # every forward hit with diag == start is correct; the true diagonal
    # must dominate
    diags = res["rpos"][0][fwd] - res["qpos"][0][fwd]
    vals, counts = np.unique(diags, return_counts=True)
    assert vals[np.argmax(counts)] == start
    # hits sorted by (strand, qpos, rpos)
    key = (res["strand"][0].astype(np.int64) << 52
           | res["qpos"][0].astype(np.int64) << 32
           | res["rpos"][0].astype(np.int64))[v]
    assert (np.diff(key) >= 0).all()


def test_seed_hits_reverse_strand(rng):
    k = 11
    ref = rng.integers(0, 4, 8000).astype(np.uint8)
    idx = KmerIndex.build(ref, k)
    start = 5000
    frag = ref[start:start + 150]
    read = np.frombuffer(revcomp4(bytes(frag.astype(np.uint8))), np.uint8)
    res = _run_seed_hits([read], [150], idx, k, 256)
    v = res["valid"][0]
    rev = v & (res["strand"][0] == 1)
    assert rev.any()
    # in rc coordinates the read equals frag, so diag == start dominates
    diags = res["rpos"][0][rev] - res["qpos"][0][rev]
    vals, counts = np.unique(diags, return_counts=True)
    assert vals[np.argmax(counts)] == start


def test_seed_hits_with_errors_still_vote(rng):
    k = 11
    genome = sim.random_genome(rng, 20000)
    ref = codes_of(genome[0].seq)
    idx = KmerIndex.build(ref, k)
    reads = sim.simulate_reads(rng, genome, 5, read_len=(400, 600),
                               sub=0.02, ins=0.04, dele=0.03)
    for r in reads:
        (p,) = sim.parse_truth(r.name)
        rcodes = codes_of(r.seq)
        res = _run_seed_hits([rcodes], [len(rcodes)], idx, k, 1024,
                             step=3, C=8, H=512)
        v = res["valid"][0]
        s = res["strand"][0]
        want_strand = 0 if p.strand == "+" else 1
        sel = v & (s == want_strand)
        assert sel.sum() >= 10, f"too few hits for {r.name}"
        diags = res["rpos"][0][sel] - res["qpos"][0][sel]
        near = np.abs(diags - p.ref_start) < 400
        assert near.sum() >= 10, f"no diagonal vote for {r.name}"


def test_seed_hits_direct_matches_search(rng):
    """Direct-address (dense 4^k) lookup must reproduce the binary
    search path bit-for-bit (the device path uses it for k <= 13)."""
    from lamsa_tpu.pipeline.seeding import (pack_positions16,
                                            seed_hits_direct)
    k = 9
    genome = sim.random_genome(rng, 20000)
    ref = codes_of(genome[0].seq)
    idx = KmerIndex.build(ref, k)
    reads = sim.simulate_reads(rng, genome, 8, read_len=(200, 400),
                               sub=0.02, ins=0.03, dele=0.03)
    L = 512
    B = len(reads)
    rc = np.full((B, L), 4, np.int32)
    rl = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        c = codes_of(r.seq)[:L]
        rc[i, :len(c)] = c
        rl[i] = len(c)
    grid = make_qpos_grid(L, k, 10)
    common = dict(k=k, cands_per_seed=8, max_hits=256)
    pos = idx.positions.astype(np.uint32)
    want = seed_hits(rc, rl, grid, idx.keys, idx.starts, idx.counts,
                     pos, **common)
    dense_s = np.zeros(4 ** k, np.int32)
    dense_c = np.zeros(4 ** k, np.int32)
    dense_s[idx.keys] = idx.starts
    dense_c[idx.keys] = idx.counts
    got = seed_hits_direct(rc, rl, grid, dense_s, dense_c,
                           pack_positions16(pos), **common)
    for name in ("qpos", "rpos", "strand", "valid"):
        assert np.array_equal(np.asarray(got[name]),
                              np.asarray(want[name])), name
    assert np.asarray(want["valid"]).any()
