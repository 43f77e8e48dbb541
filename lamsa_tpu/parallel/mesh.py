"""Multi-chip data parallelism over reads.

The reference's only parallelism is a pthread pool over reads
(SURVEY.md section 2b); the device equivalent (BASELINE.json north
star) is read-level data parallelism over a ``jax.sharding.Mesh``: the
read batch's leading dimension is sharded across devices, the index
arrays are replicated (genome-scale k-mer tables fit each device's
memory; see parallel/multihost.py for host-level
sharding), and every device stage — seeding gathers, chain scan, banded
DP — partitions trivially along the batch axis, so XLA inserts no
collectives in the hot path at all. SAM assembly merges on hosts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def shard_batch(mesh: Mesh, *arrays):
    """Place arrays with the leading (read/instance) dim sharded."""
    out = []
    for a in arrays:
        spec = P(DATA_AXIS, *([None] * (np.ndim(a) - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)


def replicate(mesh: Mesh, *arrays):
    out = [jax.device_put(a, NamedSharding(mesh, P())) for a in arrays]
    return tuple(out)


@functools.partial(jax.jit, static_argnames=("k", "cands_per_seed",
                                             "max_hits", "weight",
                                             "lookback", "max_dist",
                                             "diag_slack"))
def seed_chain_step(read_codes, read_len, qpos_grid, idx_keys, idx_starts,
                    idx_counts, idx_positions, *, k, cands_per_seed,
                    max_hits, weight, lookback, max_dist, diag_slack):
    """Fused device stage: seeding + chaining for one sharded batch.
    Under a mesh, the batch dim partitions; everything else replicates."""
    from lamsa_tpu.ops.chain import chain_hits
    from lamsa_tpu.pipeline.seeding import seed_hits

    hits = seed_hits(read_codes, read_len, qpos_grid, idx_keys, idx_starts,
                     idx_counts, idx_positions, k=k,
                     cands_per_seed=cands_per_seed, max_hits=max_hits)
    f, pred = chain_hits(hits["qpos"], hits["rpos"], hits["strand"],
                         hits["valid"], weight=weight, lookback=lookback,
                         max_dist=max_dist, diag_slack=diag_slack)
    return {**hits, "f": f, "pred": pred}


@functools.partial(jax.jit, static_argnames=("match", "mismatch", "gapo",
                                             "gape"))
def banded_dp_step(q, t_win, m_len, n_len, lo, *, match, mismatch, gapo,
                   gape):
    """Sharded banded-DP stage (the XLA DP; its batch dim partitions
    with no collectives)."""
    from lamsa_tpu.ops.banded_sw import extract_scores
    from lamsa_tpu.ops.banded_sw_xla import banded_sw_batch

    res = banded_sw_batch(q, t_win, m_len, n_len, lo, match=match,
                          mismatch=mismatch, gapo=gapo, gape=gape,
                          with_dirs=False)
    g, te, te_d = extract_scores(res["h_last"], m_len, n_len, lo)
    return {"global_score": g, "te_score": te, "te_d": te_d,
            "best": res["best"]}


def full_align_step(mesh: Mesh, batch: dict, index: dict, dp: dict,
                    config, shard_index: bool = False) -> dict:
    """One data-parallel 'training-step equivalent': sharded
    seed -> chain -> banded-DP scoring across the mesh. `batch`/`dp`
    leading dims are sharded; `index` is replicated per chip, or — with
    shard_index=True — split into per-chip key ranges with the hit
    lists exchanged over ICI (parallel/sharded_index.py).
    """
    (rc, rl) = shard_batch(mesh, batch["codes"], batch["len"])
    chain_kw = dict(
        k=index["k"], cands_per_seed=config.max_cands_per_seed,
        max_hits=config.max_hits_per_read, weight=index["k"],
        lookback=config.chain_lookback, max_dist=config.chain_max_dist,
        diag_slack=config.chain_diag_slack)
    if shard_index:
        from lamsa_tpu.index.kmer import KmerIndex
        from lamsa_tpu.parallel.sharded_index import (
            place_sharded, seed_chain_step_sharded, shard_kmer_index)
        kidx = KmerIndex(k=index["k"], keys=np.asarray(index["keys"]),
                         starts=np.asarray(index["starts"]),
                         counts=np.asarray(index["counts"]),
                         positions=np.asarray(index["positions"]))
        sh = place_sharded(mesh, shard_kmer_index(kidx, mesh.devices.size))
        (grid,) = replicate(mesh, index["grid"])
        sc = seed_chain_step_sharded(
            rc, rl, grid, sh["keys"], sh["starts"], sh["counts"],
            sh["positions"], mesh=mesh, **chain_kw)
    else:
        (grid, keys, starts, counts, positions) = replicate(
            mesh, index["grid"], index["keys"], index["starts"],
            index["counts"], index["positions"])
        sc = seed_chain_step(rc, rl, grid, keys, starts, counts,
                             positions, **chain_kw)
    (q, t_win, m_len, n_len, lo) = shard_batch(
        mesh, dp["q"], dp["t_win"], dp["m_len"], dp["n_len"], dp["lo"])
    s = config.scores
    dpr = banded_dp_step(q, t_win, m_len, n_len, lo, match=s.match,
                         mismatch=s.mismatch, gapo=s.gap_open,
                         gape=s.gap_ext)
    return {"chain": sc, "dp": dpr}
