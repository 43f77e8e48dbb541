"""Sharded-index seeding: k-mer table split across chips, hit exchange.

The replicated-index mode (parallel/mesh.py) keeps a full index copy in
every device's memory. For indexes that exceed one device (GRCh38 position
tables at low k, pan-genome references), SURVEY.md section 5
("Distributed communication backend" row) prescribes the alternative:
shard the index across chips and all-gather hit lists. This module is
that mode:

  * the sorted k-mer table is split into n_shards contiguous KEY RANGES
    (host-side, `shard_kmer_index`); each device holds one range's
    keys/starts/counts plus exactly its slice of the positions array —
    per-device memory drops by ~n_shards;
  * seeding runs under `jax.shard_map` over the data mesh axis: reads
    are all-gathered so every chip probes the full batch against its
    local key range (a key lives on exactly one shard, so per-candidate
    contributions are disjoint), then candidate (pos, ok) tensors are
    combined with ONE `psum_scatter` along the batch axis — each chip
    ends up with the complete hit set for its own read shard, and the
    pipeline continues purely data-parallel (chain scan, banded DP)
    with no further collectives;
  * both collectives ride ICI (mesh-axis neighbors), and the exchanged
    tensor is the (B, S, C) candidate block — the "all-gather of hit
    lists" in the survey, fused into a single reduce-scatter instead of
    gather + local slice (half the bytes on the wire).

Output contract: bit-identical to pipeline/seeding.py::seed_hits on the
same batch (tests/test_sharded_index.py asserts array equality), so the
host pipeline cannot tell the modes apart.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from lamsa_tpu.parallel.mesh import DATA_AXIS

# Sentinel for key padding: >= every real 2-bit-packed key. For k=16 the
# all-T key equals the sentinel; padded rows carry count 0, so a probe
# that lands on one yields zero candidates rather than a false hit.
_PAD_KEY = np.uint32(0xFFFFFFFF)


def shard_kmer_index(index, n_shards: int) -> dict:
    """Split a KmerIndex into n_shards contiguous key ranges.

    Returns host arrays stacked on a leading shard dim, equal-shaped per
    shard (padded with sentinel keys / zero counts / zero positions):
      keys uint32[D, Ks], starts int32[D, Ks], counts int32[D, Ks],
      positions uint32[D, Ps], plus {"k": index.k}.
    """
    U = len(index.keys)
    D = n_shards
    Ks = max(1, -(-U // D))
    bounds = [min(U, d * Ks) for d in range(D + 1)]
    pos_slices = []
    for d in range(D):
        k0, k1 = bounds[d], bounds[d + 1]
        if k0 >= k1:
            pos_slices.append((0, 0))
            continue
        p0 = int(index.starts[k0])
        p1 = int(index.starts[k1 - 1] + index.counts[k1 - 1])
        pos_slices.append((p0, p1))
    Ps = max(1, max(p1 - p0 for p0, p1 in pos_slices))

    keys = np.full((D, Ks), _PAD_KEY, np.uint32)
    starts = np.zeros((D, Ks), np.int32)
    counts = np.zeros((D, Ks), np.int32)
    positions = np.zeros((D, Ps), np.uint32)
    for d in range(D):
        k0, k1 = bounds[d], bounds[d + 1]
        if k0 >= k1:
            continue
        p0, p1 = pos_slices[d]
        n = k1 - k0
        keys[d, :n] = index.keys[k0:k1]
        starts[d, :n] = index.starts[k0:k1] - p0
        counts[d, :n] = index.counts[k0:k1]
        positions[d, :p1 - p0] = index.positions[p0:p1].astype(np.uint32)
    return {"k": index.k, "keys": keys, "starts": starts,
            "counts": counts, "positions": positions}


def place_sharded(mesh, sharded: dict) -> dict:
    """Device placement: one index shard per chip (leading dim sharded
    over the data axis)."""
    out = {"k": sharded["k"]}
    for name in ("keys", "starts", "counts", "positions"):
        out[name] = jax.device_put(
            sharded[name],
            NamedSharding(mesh, P(DATA_AXIS, None)))
    return out


@functools.partial(jax.jit,
                   static_argnames=("mesh", "k", "cands_per_seed",
                                    "max_hits"))
def seed_hits_sharded(read_codes, read_len, qpos_grid, keys, starts,
                      counts, positions, *, mesh, k, cands_per_seed,
                      max_hits):
    """seed_hits against a key-range-sharded index.

    read_codes/read_len are batch-sharded over the mesh's data axis;
    keys/starts/counts/positions are (D, …) with the leading dim
    sharded (one key range per chip). Returns the seed_hits dict,
    batch-sharded, bit-identical to the replicated-index result.
    """
    from lamsa_tpu.pipeline.seeding import (extract_windows, pack_hits,
                                            table_lookup, window_keys)
    C = cands_per_seed

    def local(rc, rl, grid, kkeys, kstarts, kcounts, kpos):
        kkeys, kstarts = kkeys[0], kstarts[0]
        kcounts, kpos = kcounts[0], kpos[0]
        # every chip probes the whole batch against its key range
        rc_all = jax.lax.all_gather(rc, DATA_AXIS, tiled=True)
        rl_all = jax.lax.all_gather(rl, DATA_AXIS, tiled=True)
        win, win_ok = extract_windows(rc_all, rl_all, grid, k)
        key_f, key_r = window_keys(win, k)
        pos_f, ok_f = table_lookup(key_f, kkeys, kstarts, kcounts, kpos, C)
        pos_r, ok_r = table_lookup(key_r, kkeys, kstarts, kcounts, kpos, C)
        # disjoint key ranges -> at most one shard contributes per
        # candidate slot; one reduce-scatter returns each chip the full
        # candidate set for its own read shard
        stack = jnp.stack([
            jnp.where(ok_f, pos_f, jnp.uint32(0)),
            jnp.where(ok_r, pos_r, jnp.uint32(0)),
            ok_f.astype(jnp.uint32),
            ok_r.astype(jnp.uint32),
        ])
        stack = jax.lax.psum_scatter(stack, DATA_AXIS,
                                     scatter_dimension=1, tiled=True)
        pos_f_m, pos_r_m = stack[0], stack[1]
        ok_f_m, ok_r_m = stack[2] > 0, stack[3] > 0
        win_ok_mine = jax.lax.dynamic_slice_in_dim(
            win_ok, jax.lax.axis_index(DATA_AXIS) * rc.shape[0],
            rc.shape[0], axis=0)
        return pack_hits(grid, rl, pos_f_m, ok_f_m, pos_r_m, ok_r_m,
                         win_ok_mine, k=k, max_hits=max_hits)

    shard = P(DATA_AXIS)
    idx_spec = P(DATA_AXIS, None)
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(shard, shard, P(None), idx_spec, idx_spec, idx_spec,
                  idx_spec),
        out_specs={"qpos": shard, "rpos": shard, "strand": shard,
                   "valid": shard},
    )(read_codes, read_len, qpos_grid, keys, starts, counts, positions)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "k", "cands_per_seed",
                                    "max_hits", "weight", "lookback",
                                    "max_dist", "diag_slack"))
def seed_chain_step_sharded(read_codes, read_len, qpos_grid, keys, starts,
                            counts, positions, *, mesh, k, cands_per_seed,
                            max_hits, weight, lookback, max_dist,
                            diag_slack):
    """Fused sharded-index seeding + data-parallel chaining (the
    sharded-mode twin of parallel/mesh.py::seed_chain_step)."""
    from lamsa_tpu.ops.chain import chain_hits

    hits = seed_hits_sharded(read_codes, read_len, qpos_grid, keys, starts,
                             counts, positions, mesh=mesh, k=k,
                             cands_per_seed=cands_per_seed,
                             max_hits=max_hits)
    f, pred = chain_hits(hits["qpos"], hits["rpos"], hits["strand"],
                         hits["valid"], weight=weight, lookback=lookback,
                         max_dist=max_dist, diag_slack=diag_slack)
    return {**hits, "f": f, "pred": pred}
