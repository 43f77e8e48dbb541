"""Time and trace the fused DP chain per (M, W) bucket on the GPU.

    python tools/dp_chain_profile.py [--out DIR]

For every bucket at its CHUNK_BY_M batch (bench.chain_case inputs):
ms per chunk and Gcells/s (bench.bench_kernel), then one traced call
read back from the profiler's xplane file:
  * kernels: kernel launches on the GPU stream lines during the call;
  * per row: launches per DP row (the DP scan and the traceback walk
    each run M iterations, so this is their summed body size);
  * busy: union of kernel intervals over the call's span, and the
    mean gap between consecutive kernels — a launch-bound scan shows
    short kernels separated by gaps of similar size.
Writes DIR/dp_chain_profile.json: the summaries, the top kernel names,
the trace's line inventory and the first 2000 kernels of each call.
Needs a GPU.
"""

import argparse
import glob
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402


def device_kernels(xplane_path):
    """(kernels, inventory): (name, start_ns, end_ns) of every event on
    the GPU planes' stream lines sorted by start, and (plane, line,
    event count) of every line of the trace."""
    from jax.profiler import ProfileData
    out, inventory = [], []
    for plane in ProfileData.from_file(xplane_path).planes:
        for line in plane.lines:
            events = list(line.events)
            inventory.append((plane.name, line.name, len(events)))
            if plane.name.startswith("/device:GPU") and \
                    line.name.startswith("Stream"):
                out.extend((e.name, e.start_ns, e.end_ns) for e in events)
    return sorted(out, key=lambda e: e[1]), inventory


def summarize(kernels, M):
    if not kernels:
        return {"kernels": 0}
    span = kernels[-1][2] - kernels[0][1]
    busy, cur_s, cur_e = 0.0, kernels[0][1], kernels[0][2]
    for _, s, e in kernels[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    gaps = [max(0.0, b[1] - a[2]) for a, b in zip(kernels, kernels[1:])]
    names = {}
    for n, s, e in kernels:
        c, t = names.get(n, (0, 0.0))
        names[n] = (c + 1, t + e - s)
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "kernels": len(kernels),
        "kernels_per_row": len(kernels) / M,
        "span_ms": span / 1e6,
        "busy_ms": busy / 1e6,
        "busy_share": busy / span if span else 0.0,
        "mean_kernel_us": sum(e - s for _, s, e in kernels)
        / len(kernels) / 1e3,
        "mean_gap_us": sum(gaps) / max(len(gaps), 1) / 1e3,
        "top": [{"name": n[:80], "count": c, "ms": t / 1e6}
                for n, (c, t) in top],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    import jax

    from lamsa_tpu.device import enable_compile_cache, use_device_path
    from lamsa_tpu.ops.banded_sw import _dp_tb_fused_gather
    from lamsa_tpu.pipeline.extend import BUCKETS, CHUNK_BY_M
    enable_compile_cache()
    if not use_device_path():
        raise SystemExit("needs a GPU")
    dev = jax.devices()[0]
    timing = bench.bench_kernel()
    S = bench.scores()
    kw = dict(match=S.match, mismatch=S.mismatch, gapo=S.gap_open,
              gape=S.gap_ext, zdrop=S.zdrop)
    result = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}, "buckets": {}}
    for M, W in BUCKETS:
        flat, refd, desc, cells = bench.chain_case(M, W)
        _dp_tb_fused_gather(flat, refd, desc, M=M, W=W,
                            **kw).block_until_ready()
        with tempfile.TemporaryDirectory() as tdir:
            with jax.profiler.trace(tdir):
                _dp_tb_fused_gather(flat, refd, desc, M=M, W=W,
                                    **kw).block_until_ready()
            path = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                             recursive=True)[0]
            kernels, inventory = device_kernels(path)
            summ = summarize(kernels, M)
            summ["lines"] = inventory
            t0 = kernels[0][1] if kernels else 0
            summ["first_kernels"] = [(n[:60], s - t0, e - s)
                                     for n, s, e in kernels[:2000]]
        ms, gcells = timing[(M, W)]
        summ.update(B=CHUNK_BY_M[(M, W)], ms_per_chunk=ms,
                    gcells_per_s=gcells, real_cells=cells)
        result["buckets"][f"{M}x{W}"] = summ
        print(f"({M}, {W}) B={summ['B']}: {ms:.2f} ms/chunk, "
              f"{gcells:.3f} Gcells/s; {summ.get('kernels')} kernels "
              f"({summ.get('kernels_per_row', 0):.1f}/row), busy share "
              f"{summ.get('busy_share', 0):.3f}, mean kernel "
              f"{summ.get('mean_kernel_us', 0):.2f} us, mean gap "
              f"{summ.get('mean_gap_us', 0):.2f} us", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "dp_chain_profile.json"), "w") as fh:
        json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
