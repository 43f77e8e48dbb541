"""The accelerator path on the CPU: the one device decision, the fused
device chain (ops/banded_sw.py `_dp_tb_fused_gather`) against the CPU
engine, chunk routing, the whole aligner with the device path forced,
the compile-cache helper, and chip_smoke's refusal of a non-GPU."""

import os

import jax
import numpy as np
import pytest

import lamsa_tpu.device as device
import lamsa_tpu.pipeline.extend as extend
from lamsa_tpu import sim
from lamsa_tpu.config import ScoreParams
from lamsa_tpu.ops.banded_sw import compact_overflows, pack_codes_words

# the CLI's default scoring (its gap costs keep the deletion ladders of
# sim.dp_instances apart as separate D events)
S = ScoreParams(match=1, mismatch=3, gap_open=2, gap_ext=1)


def _force_device_path(monkeypatch):
    """The device path everywhere except inside jax.default_device(cpu)
    (how chip_smoke runs the CPU engine beside it)."""
    monkeypatch.setattr(
        device, "default_platform",
        lambda: "cpu" if jax.config.jax_default_device is not None
        else "gpu")


def _run(inst, on_device):
    srcs = None
    if on_device:
        srcs = (jax.device_put(pack_codes_words(inst["flat"])),
                jax.device_put(pack_codes_words(inst["ref"])))
    b = extend.DpBatcher(S, host_sources=(inst["flat"], inst["ref"]),
                         device_sources=srcs)
    handles = sim.enqueue_dp_instances(b, inst)
    b.run()
    return [b.result(h) for h in handles]


def test_device_decision_by_platform(monkeypatch):
    assert device.use_device_path() is False          # tests run on CPU
    with jax.default_device(jax.devices("cpu")[0]):
        assert device.use_device_path() is False
    monkeypatch.setattr(device, "default_platform", lambda: "gpu")
    assert device.use_device_path() is True
    monkeypatch.setattr(device, "default_platform", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported"):
        device.use_device_path()


@pytest.mark.parametrize("M,W,count", [(128, 128, 24), (128, 256, 12),
                                       (512, 256, 12), (2048, 256, 6),
                                       (5120, 256, 8)])
def test_fused_chain_matches_cpu_engine(monkeypatch, M, W, count):
    """Descriptor instances through the fused device chain (gather ->
    XLA DP -> walk -> compact wire -> decode, host recompute on wire
    overflow) == the CPU engine (XLA DP + native host traceback):
    score, CIGAR and end cell of every instance."""
    _force_device_path(monkeypatch)
    inst = sim.dp_instances(np.random.default_rng(M + W), M, W, count)
    got = _run(inst, True)
    with jax.default_device(jax.devices("cpu")[0]):
        want = _run(inst, False)
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a.score, a.q_used, a.t_used) == \
            (b.score, b.q_used, b.t_used), i
        np.testing.assert_array_equal(a.cigar, b.cigar, err_msg=str(i))
    if W == 256 and M < 1024:
        # long deletions: D runs past the narrow event field
        assert any(compact_overflows(r.cigar, M) for r in want)


def test_fused_chain_wide_event_overflow(monkeypatch):
    """The 5120-row bucket's wide events: instances dense in small
    deletions carry more D events than the wire holds and come back
    through the host recompute, identical to the CPU engine."""
    _force_device_path(monkeypatch)
    rng = np.random.default_rng(5)
    inst = sim.dp_instances(rng, 5120, 256, 12)
    with jax.default_device(jax.devices("cpu")[0]):
        want = _run(inst, False)
    want_over = [compact_overflows(r.cigar, 5120) for r in want]
    assert any(want_over)
    keep = [i for i, o in enumerate(want_over) if o][:2] + \
        [i for i, o in enumerate(want_over) if not o][:2]
    sub = dict(inst, items=[inst["items"][i] for i in keep])
    got = _run(sub, True)
    for a, i in zip(got, keep):
        b = want[i]
        assert (a.score, a.q_used, a.t_used) == \
            (b.score, b.q_used, b.t_used)
        np.testing.assert_array_equal(a.cigar, b.cigar)


def test_routing_dispatches_every_instance_once(rng, monkeypatch):
    """Each bucket's instances (globals and extensions together) are
    dispatched exactly once, in chunks of one bucket no larger than its
    CHUNK_BY_M — including the mixed bulk+scalar enqueue whose column
    merge promotes the glob column to int64."""
    calls = []

    def fake_dispatch_cols(self, sl, M, W):
        calls.append((M, W, np.array(sl["idx"], copy=True),
                      np.array(sl["m"], copy=True),
                      np.array(sl["n"], copy=True),
                      np.array(sl["glob"], copy=True)))
        return sl, M, W, None

    def fake_collect(self, sl, M, W, dev):
        for b in range(len(sl["idx"])):
            self._results[int(sl["idx"][b])] = extend.DpResult(
                0, extend._EMPTY_CIGAR, 0, 0)

    monkeypatch.setattr(extend.DpBatcher, "_dispatch_cols",
                        fake_dispatch_cols)
    monkeypatch.setattr(extend.DpBatcher, "_collect_device", fake_collect)
    monkeypatch.setattr(extend, "CHUNK_BY_M",
                        {k: 16 for k in extend.CHUNK_BY_M})
    _force_device_path(monkeypatch)

    b = extend.DpBatcher(S, device_sources=(object(), object()))
    K = 40
    m = rng.integers(300, 500, K)
    n = m + rng.integers(80, 110, K)          # need > 80 -> W=256
    h0 = b.add_globals_bulk(m, n, np.zeros(K, np.int64), 1, 0,
                            np.arange(K, dtype=np.int64) * 1000)
    K2 = 24
    m2 = rng.integers(300, 500, K2)
    n2 = m2 + rng.integers(-10, 10, K2)       # need <= 80 -> W=128
    h2 = b.add_globals_bulk(m2, n2, np.zeros(K2, np.int64), 1, 0,
                            np.arange(K2, dtype=np.int64) * 1000)
    hs = [b.add_extend_desc(400, 420, 5, (0, 1, 0), (7, 1))
          for _ in range(3)]
    hg = b.add_global_desc(350, 440, (0, 1, 0), (9, 1))
    b.run()

    handles = [h0 + i for i in range(K)] + [h2 + i for i in range(K2)] \
        + hs + [hg]
    for h in handles:
        assert b.result(h) is not None
    seen = set()
    for M, W, idx, ms, ns, glob in calls:
        assert 0 < len(idx) <= 16
        for i, mi, ni, gi in zip(idx, ms, ns, glob):
            assert int(i) not in seen, "instance dispatched twice"
            seen.add(int(i))
            kind = "global" if gi else "extend"
            first = next(bk for bk in extend.BUCKETS
                         if extend._bucket_fits(kind, mi, ni, *bk))
            assert first == (M, W)
    assert seen == set(handles)
    mixed = [g.astype(bool) for *_, g in calls]
    assert any(g.any() and not g.all() for g in mixed), \
        "globals and extensions of a bucket share its chunks"


def test_device_path_e2e_sam_identical(monkeypatch):
    """The whole aligner on the device path (dense k-mer tables,
    reference and reads resident, descriptor-gathered windows, fused
    chain, 3-deep batch pipeline), forced onto the CPU, emits SAM
    byte-identical to the CPU engine."""
    from lamsa_tpu.config import AlignConfig
    from lamsa_tpu.index.kmer import KmerIndex
    from lamsa_tpu.io.fasta import encode_seq
    from lamsa_tpu.io.refpack import PackedReference
    from lamsa_tpu.io.sam import format_sam_record
    from lamsa_tpu.pipeline.aln import Aligner, align_reads

    rng = np.random.default_rng(11)
    genome = sim.random_genome(rng, 60000)
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    ref = PackedReference(names=["chr1"],
                          offsets=np.array([0, len(codes)], np.int64),
                          codes=codes, amb_runs=np.zeros((0, 2), np.int64))
    idx = KmerIndex.build(codes, 13)
    cfg = AlignConfig(scores=S, seed_step=10)
    reads = sim.simulate_reads(rng, genome, 24, read_len=(500, 3000),
                               sub=0.02, ins=0.04, dele=0.04,
                               sv_fraction=0.3)

    def sam(recs):
        return [format_sam_record(r) for rr in recs for r in rr]

    host = sam(Aligner(ref, idx, cfg).align_batch(reads))
    _force_device_path(monkeypatch)
    monkeypatch.setenv("LAMSA_INFLIGHT_BUDGET", str(1 << 30))
    a = Aligner(ref, idx, cfg)
    assert a.device_path and "dense_starts" in a._dev
    assert a._ref_dev is not None
    dev = sam(align_reads(ref, idx, reads, cfg, batch_size=8, aligner=a))
    assert dev == host


class _Dev:
    device_kind = "test device"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_inflight_budget_from_device_memory(monkeypatch):
    """The in-flight budget is a fraction of the device's bytes_limit
    minus resident arrays; a device that reports no limit is an error,
    not an assumed size."""
    from lamsa_tpu.pipeline.aln import Aligner
    monkeypatch.delenv("LAMSA_INFLIGHT_BUDGET", raising=False)
    a = Aligner.__new__(Aligner)
    a._ref_dev, a._dev = np.zeros(1 << 20, np.uint8), {}
    monkeypatch.setattr(jax, "local_devices",
                        lambda: [_Dev({"bytes_limit": 10 << 30})])
    assert a._compute_inflight_budget() == int(((10 << 30) - (1 << 20))
                                               * 0.6)
    monkeypatch.setattr(jax, "local_devices", lambda: [_Dev(None)])
    with pytest.raises(RuntimeError, match="bytes_limit"):
        a._compute_inflight_budget()


@pytest.mark.parametrize("env", [True, False])
def test_compile_cache_location(monkeypatch, tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code;
    otherwise the cache goes to <repo>/.jax_cache."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env:
        monkeypatch.setenv(device.CACHE_ENV, str(tmp_path))
        assert device.enable_compile_cache() == str(tmp_path)
        assert calls == []
    else:
        monkeypatch.delenv(device.CACHE_ENV, raising=False)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        want = os.path.join(repo, ".jax_cache")
        assert device.enable_compile_cache() == want
        assert calls == [("jax_compilation_cache_dir", want)]


class _FakeGpu:
    platform = "gpu"
    device_kind = "fake"


@pytest.mark.parametrize("case", ["cpu", "too_few_gpus"])
def test_chip_smoke_refuses_without_gpus(monkeypatch, case):
    import chip_smoke
    if case == "cpu":
        with pytest.raises(chip_smoke.Failed, match="need a GPU"):
            chip_smoke.check_device(jax.devices(), 1)
        return
    monkeypatch.setattr(device, "default_platform", lambda: "gpu")
    with pytest.raises(chip_smoke.Failed, match="need 4 GPUs"):
        chip_smoke.check_device([_FakeGpu()], 4)
    chip_smoke.check_device([_FakeGpu()] * 4, 4)      # accepted
