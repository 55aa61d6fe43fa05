"""Compile time, step time, memory and kernel census of the packed XLA scan
step on the local accelerator.

For each case it lowers and compiles ``pipeline.packed_xla_scan_step`` at
the given batch, reports ``compiled.memory_analysis()`` and
``compiled.cost_analysis()`` (bytes per key), times steady steps to
``block_until_ready``, and with ``--trace`` reduces one short
``jax.profiler`` trace to the number of device kernels one step launches
and the kernels that take the most device time.

    python scripts/profile_step.py \\
        --runs p2pkh-range-glv:64,p2pkh-dfa-glv:64 \\
        --parallel-runs p2pkh-range:64,p2pkh-range:256 \\
        --trace --out profile_census

A run is case:chain (the inversion chain length).  --runs compile one after another;
--parallel-runs compile together on a thread pool (XLA compiles outside
the interpreter lock), each timed as soon as it is compiled.  Prints one
JSON object per run on stdout; with --out, each trace's full census is
written there as JSON (the trace itself is discarded).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import secrets
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# case -> (format, pattern); the route (interval or DFA, GLV) follows from
# the pattern exactly as in a random scan
CASES = {
    "p2pkh-range-glv": ("p2pkh", "^1Cat"),
    "p2pkh-range": ("p2pkh", "^1Cat"),  # range scan: GLV off
    "p2pkh-dfa-glv": ("p2pkh", "Cat$"),
    "p2tr-range": ("p2tr", "^bc1pcat"),
    "p2tr-dfa": ("p2tr", "cat$"),
    "p2pkh-u-range-glv": ("p2pkh-uncompressed", "^1Cat"),
    "p2wpkh-range-glv": ("p2wpkh", "^bc1qcat"),
    "p2sh-range-glv": ("p2sh-p2wpkh", "^3Cat"),
    "eth-range-glv": ("ethereum", "^0xcafe"),
}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def _busy_ns(spans) -> float:
    """Length of the union of (start, end) spans."""
    busy, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy


def trace_census(trace_dir: str, n_steps: int) -> dict:
    """Device kernels per step and the heaviest kernels, from the xplane."""
    import jax

    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not paths:
        return {"error": "no xplane written"}
    pd = jax.profiler.ProfileData.from_file(sorted(paths)[-1])
    lines = {}
    per_kernel = {}
    spans = []
    by_plane = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = len(evs)
            if line.name.startswith("XLA") or "Stream" not in line.name:
                continue
            for e in evs:
                k = per_kernel.setdefault(e.name, [0, 0.0])
                k[0] += 1
                k[1] += e.duration_ns
                spans.append((e.start_ns, e.start_ns + e.duration_ns))
                by_plane.setdefault(plane.name, []).append(spans[-1])
    window = (max(t for _, t in spans) - min(s for s, _ in spans)
              if spans else 0.0)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "lines": lines,
        "kernels_per_step": sum(c for c, _ in per_kernel.values()) / n_steps,
        "distinct_kernels": len(per_kernel),
        "device_busy_ms_per_step": _busy_ns(spans) / n_steps / 1e6,
        "busy_ms_per_step_by_device": {
            name: _busy_ns(sp) / n_steps / 1e6
            for name, sp in sorted(by_plane.items())
        },
        "kernel_window_ms": window / 1e6,
        "top": [
            {"name": n[:120], "calls": c, "ms_per_step": d / n_steps / 1e6}
            for n, (c, d) in top
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="p2pkh-range-glv:64,"
                    "p2pkh-dfa-glv:64,p2tr-range:64")
    ap.add_argument("--parallel-runs", default="")
    ap.add_argument("--batch", type=int, default=524_288)
    ap.add_argument("--k-sub", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from vgen_tpu.crypto import secp256k1 as ec
    from vgen_tpu.crypto.address import AddressFormat
    from vgen_tpu.ops import pipeline
    from vgen_tpu.pattern import Pattern
    from vgen_tpu.scan import route, tables

    dev = jax.devices()[0]
    print(f"# card: {card()}", flush=True)
    print(f"# jax {jax.__version__} devices: {jax.devices()}", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    B, K = args.batch, args.k_sub

    t0 = time.perf_counter()
    tx, ty = tables.ig_table_arrays(B, dev)
    print(f"# i*G table {time.perf_counter() - t0:.2f}s", flush=True)
    wt = jax.device_put(jnp.asarray(tables.window_table_u32(8)), dev)

    scalars = [2 + secrets.randbelow(ec.N - 2 * K * B) for _ in range(1)]
    base = [scalars[0] + k * B for k in range(K)]
    pts = [ec.scalar_mult_base_fast(s) for s in base]
    bx = jnp.asarray(tables._ints_to_limbs([p[0] for p in pts]))
    by = jnp.asarray(tables._ints_to_limbs([p[1] for p in pts]))
    rem = jnp.full((K,), B, dtype=jnp.int32)

    def prepare(spec):
        name, chain = spec.split(":")
        chain = int(chain)
        fmt_s, pat_s = CASES[name]
        fmt = AddressFormat.from_str(fmt_s)
        pat = Pattern(pat_s)
        is_range = name == "p2pkh-range"
        ivs = route.plan_intervals(pat, fmt, B, is_range)
        r = route.route(dev.platform, fmt, ivs, is_range, K)
        margs = pipeline.matcher_args(pat, fmt, ivs)
        extras = (wt,) if fmt == AddressFormat.P2TR else ()
        step = pipeline.packed_xla_scan_step(fmt, r.kind, r.glv, chain, K)
        call = (bx, by, tx, ty, rem) + margs + extras
        rec = {"case": name, "kind": r.kind, "glv": r.glv,
               "chain": chain, "batch": B, "k_sub": K}
        return rec, step, call

    def compile_one(item):
        rec, step, call = item
        t0 = time.perf_counter()
        lowered = step.lower(*call)
        rec["lower_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = lowered.compile()
        rec["compile_s"] = time.perf_counter() - t0
        return compiled

    def measure(rec, compiled, call):
        ma = compiled.memory_analysis()
        if ma is not None:
            rec["memory"] = {
                k: getattr(ma, k) for k in (
                    "argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "generated_code_size_in_bytes",
                ) if hasattr(ma, k)
            }
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0] if ca else {}
        ca = ca or {}
        keys = K * B
        rec["cost"] = {
            "bytes_accessed": ca.get("bytes accessed"),
            "flops": ca.get("flops"),
            "bytes_per_key": (ca.get("bytes accessed") or 0) / keys,
        }
        packed, _ = jax.block_until_ready(compiled(*call))
        assert packed.shape == (K, pipeline.PACKED_WIDTH), packed.shape
        times = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(*call))
            times.append(time.perf_counter() - t0)
        times.sort()
        med = times[len(times) // 2]
        rec["step_ms"] = [t * 1e3 for t in times]
        rec["step_ms_median"] = med * 1e3
        rec["window_keys_per_s"] = keys / med
        rec["ops_per_s"] = keys * (6 if rec["glv"] else 1) / med
        if args.trace:
            name = "{case}-c{chain}".format(**rec)
            with tempfile.TemporaryDirectory() as tdir:
                with jax.profiler.trace(tdir):
                    for _ in range(2):
                        jax.block_until_ready(compiled(*call))
                census = trace_census(tdir, 2)
            if args.out:
                with open(os.path.join(args.out, name + ".census.json"),
                          "w") as f:
                    json.dump(census, f, indent=1)
            rec["trace"] = {k: census.get(k) for k in (
                "kernels_per_step", "distinct_kernels",
                "device_busy_ms_per_step", "error",
            )}
            rec["trace"]["top5"] = census.get("top", [])[:5]
        stats = dev.memory_stats() or {}
        rec["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
        rec["card"] = card()
        print(json.dumps(rec), flush=True)

    for spec in filter(None, args.runs.split(",")):
        item = prepare(spec)
        measure(item[0], compile_one(item), item[2])

    specs = list(filter(None, args.parallel_runs.split(",")))
    if specs:
        from concurrent.futures import ThreadPoolExecutor, as_completed

        items = [prepare(s) for s in specs]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(items)) as pool:
            futs = {pool.submit(compile_one, it): it for it in items}
            for fut in as_completed(futs):
                rec, _, call = futs[fut]
                rec["compiled_in_parallel_with"] = len(items)
                rec["compiled_after_s"] = time.perf_counter() - t0
                measure(rec, fut.result(), call)
    return 0


if __name__ == "__main__":
    sys.exit(main())
