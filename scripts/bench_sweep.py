"""Batch-size throughput sweep -- the analog of the reference's criterion
GPU bench (benches/gpu_bench.rs:24-52, sweep {256K, 512K, 1M, 2M}).

Prints one line per (batch, k_sub) point: keys/s for the headline P2PKH
anchored-prefix scan.  Run on a gpu:  python scripts/bench_sweep.py
Env: VGEN_SWEEP_BATCHES, VGEN_SWEEP_KSUB, VGEN_BENCH_SECONDS, pattern via
VGEN_BENCH_PATTERN (default ^1C).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from vgen_tpu import compile_cache

    compile_cache.enable()

    from vgen_tpu.crypto.address import AddressFormat
    from vgen_tpu.scan.scanner import benchmark_device

    batches = [
        int(b) for b in os.environ.get(
            "VGEN_SWEEP_BATCHES", "262144,524288,1048576,2097152"
        ).split(",")
    ]
    ksubs = [
        int(k) for k in os.environ.get("VGEN_SWEEP_KSUB", "8").split(",")
    ]
    seconds = float(os.environ.get("VGEN_BENCH_SECONDS", 6))
    pattern = os.environ.get("VGEN_BENCH_PATTERN", "^1C")

    best = None
    for batch in batches:
        for k_sub in ksubs:
            t0 = time.time()
            stats = benchmark_device(
                AddressFormat.P2PKH, pattern_str=pattern,
                batch_size=batch, min_seconds=seconds, k_sub=k_sub,
            )
            row = {
                "batch": batch,
                "k_sub": k_sub,
                "keys_per_sec": stats["keys_per_sec"],
                "wall_s": round(time.time() - t0, 1),
            }
            print(json.dumps(row), flush=True)
            if best is None or row["keys_per_sec"] > best["keys_per_sec"]:
                best = row
    print(json.dumps({"best": best}), flush=True)


if __name__ == "__main__":
    main()
