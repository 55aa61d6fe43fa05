"""Range-scan rate of the mesh scanner against one card, with a breakdown of
where a mesh super-batch spends its time.

    python scripts/profile_mesh.py                 # every visible gpu
    python scripts/profile_mesh.py --devices 1 --trace-out mesh_trace

Scans the same P2PKH range (never matching, so nothing is drained) on a
MeshScanner over --devices cards and on a DeviceScanner on the first card,
and prints keys/s for each.  Then it times --super-batches mesh super-batches
one at a time: the host's share (base points, matcher arguments, dispatch)
and the wait for the result.  With --trace-out, one jax.profiler trace of
two pipelined super-batches is reduced to the devices' busy share (the
trace itself is discarded).  Prints one JSON object per measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the address of solved puzzle 30 (the smoke test's range pattern); the
# scanned range lies far above its key, so nothing matches
PATTERN = "^1LHtnpd8nU5VHEMkG2TMYYNUjjLc992bps$"


def per_device(devs, fmt, pat, B, K, chain, n_rounds, single_rate):
    """Rate of independent packed steps, one per card, all in flight at
    once: what the mesh would reach without the SPMD program."""
    import jax
    import jax.numpy as jnp

    from vgen_tpu.crypto import secp256k1 as ec
    from vgen_tpu.ops import pipeline
    from vgen_tpu.scan import route, tables

    ivs = route.plan_intervals(pat, fmt, B, True)
    r = route.route(devs[0].platform, fmt, ivs, True, K)
    step = pipeline.packed_xla_scan_step(fmt, r.kind, r.glv, chain, r.k_sub)
    base = 1 << 41
    args = []
    for d, dev in enumerate(devs):
        tx, ty = tables.ig_table_arrays(B, dev)
        pts = [ec.scalar_mult_base_fast(base + (d * K + k) * B)
               for k in range(K)]
        put = lambda a, dev=dev: jax.device_put(a, dev)
        args.append((
            put(jnp.asarray(tables._ints_to_limbs([p[0] for p in pts]))),
            put(jnp.asarray(tables._ints_to_limbs([p[1] for p in pts]))),
            tx, ty, put(jnp.full((K,), B, dtype=jnp.int32)),
            *[put(m) for m in pipeline.matcher_args(pat, fmt, ivs)],
        ))
    t0 = time.perf_counter()
    jax.block_until_ready([step(*a) for a in args])
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        jax.block_until_ready([step(*a) for a in args])
    dt = time.perf_counter() - t0
    rate = n_rounds * len(devs) * K * B / dt
    print(json.dumps({"scan": "per-device", "devices": len(devs),
                      "warm_s": warm, "keys_per_s": rate,
                      "ratio_over_single": rate / single_rate}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0, help="0 = all")
    ap.add_argument("--batch", type=int, default=524_288)
    ap.add_argument("--super-batches", type=int, default=6)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--per-device", action="store_true",
                    help="also time one independent single-device step per "
                    "card, dispatched from one thread (no collective)")
    args = ap.parse_args(argv)

    import jax

    from vgen_tpu import compile_cache
    from vgen_tpu.crypto.address import AddressFormat
    from vgen_tpu.parallel.mesh import MeshScanner, make_mesh
    from vgen_tpu.pattern import Pattern
    from vgen_tpu.scan.scanner import DeviceScanner, ScanConfig
    from scripts.profile_step import card, trace_census

    compile_cache.enable()
    devs = jax.devices()[: args.devices or None]
    print(f"# card: {card()}", flush=True)
    print(f"# jax {jax.__version__}, mesh over {devs}", flush=True)
    fmt, B = AddressFormat.P2PKH, args.batch
    pat = Pattern(PATTERN)
    mesh = MeshScanner(fmt, B, mesh=make_mesh(devs))
    single = DeviceScanner(fmt, B)
    stride = B * mesh.windows_per_super(pat)
    lo = 1 << 40

    def cfg(start, end):
        return ScanConfig(format=fmt, count=0, start=start, end=end,
                          device_batch_size=B)

    t0 = time.perf_counter()
    mesh.scan(pat, count=0, start=lo, end=lo + 1)
    single.scan(pat, cfg(lo, lo + 1))
    print(json.dumps({"warm_s": time.perf_counter() - t0}), flush=True)

    n_keys = stride * args.super_batches
    rates = {}
    for name, fn in (
        ("mesh", lambda: mesh.scan(pat, count=0, start=lo,
                                   end=lo + n_keys - 1)),
        ("single", lambda: single.scan(pat, cfg(lo, lo + n_keys - 1))),
    ):
        t0 = time.perf_counter()
        r = fn()
        dt = time.perf_counter() - t0
        rates[name] = r.operations / dt
        print(json.dumps({"scan": name, "devices": len(devs),
                          "keys": r.operations, "s": dt,
                          "keys_per_s": rates[name]}), flush=True)
    print(json.dumps({"ratio_mesh_over_single":
                      rates["mesh"] / rates["single"]}), flush=True)

    host, wait = [], []
    for j in range(args.super_batches):
        t0 = time.perf_counter()
        h = mesh.submit_super_batch(pat, lo + j * stride, None, False)
        t1 = time.perf_counter()
        mesh.drain_packed(h)
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wait.append((t2 - t1) * 1e3)
    print(json.dumps({"unpipelined_super_batch": {
        "host_submit_ms": host, "wait_ms": wait}}), flush=True)

    if args.per_device:
        per_device(devs, fmt, pat, B, mesh.k_sub, mesh.chain_len,
                   args.super_batches, rates["single"])

    if args.trace_out:
        with tempfile.TemporaryDirectory() as tdir:
            with jax.profiler.trace(tdir):
                t0 = time.perf_counter()
                mesh.scan(pat, count=0, start=lo, end=lo + 2 * stride - 1)
                wall = time.perf_counter() - t0
            census = trace_census(tdir, 2)
        census["wall_ms_per_super_batch"] = wall / 2 * 1e3
        os.makedirs(args.trace_out, exist_ok=True)
        with open(os.path.join(args.trace_out, "mesh.census.json"), "w") as f:
            json.dump(census, f, indent=1)
        print(json.dumps({"trace": {k: census.get(k) for k in (
            "kernels_per_step", "device_busy_ms_per_step",
            "kernel_window_ms", "wall_ms_per_super_batch",
            "busy_ms_per_step_by_device")},
            "top5": census.get("top", [])[:5]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
