"""Sweep k_sub (windows per dispatch) and in_flight (pipelined dispatches)
for the end-to-end DeviceScanner loop on the local gpu.

Env: B (default 524288), KS (csv, default 8,16), IF (csv, default 4,8),
SECS (default 6).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from vgen_tpu import compile_cache

compile_cache.enable()

from vgen_tpu.crypto.address import AddressFormat
from vgen_tpu.pattern import Pattern
from vgen_tpu.scan.scanner import DeviceScanner, ScanConfig, StopFlag

B = int(os.environ.get("B", 524288))
KS = [int(k) for k in os.environ.get("KS", "8,16").split(",")]
IF = [int(k) for k in os.environ.get("IF", "4,8").split(",")]
SECS = float(os.environ.get("SECS", 6))
# never-match: with a matching pattern and a huge count target the
# random-scan overflow recovery re-derives EVERY window on the host
PAT = os.environ.get("VGEN_BENCH_PATTERN", "^1CBenchNeverMatchesXx")

best = (0.0, None)
for k_sub in KS:
    scanner = DeviceScanner(AddressFormat.P2PKH, B, k_sub=k_sub)
    for inflight in IF:
        pat = Pattern(PAT)
        cfg = ScanConfig(
            format=AddressFormat.P2PKH, count=10**9,
            device_batch_size=B, in_flight=inflight,
        )
        # warmup: 2 super-steps (GLV steps report 6 ops per key, and the
        # default ^1C random scan runs with GLV on)
        glv_mult = 6
        stop = StopFlag()

        def cb(ops, _stop=stop, _k=k_sub):
            if ops >= 2 * glv_mult * _k * B:
                _stop.set()

        scanner.scan(pat, cfg, cb, stop)

        stop2 = StopFlag()
        t0 = time.time()

        def cb2(ops, _stop=stop2):
            if time.time() - t0 >= SECS:
                _stop.set()

        res = scanner.scan(pat, cfg, cb2, stop2)
        rate = res.rate() / 1e6
        print(f"k_sub={k_sub:3d} in_flight={inflight:2d}  "
              f"{rate:8.1f} Mkeys/s", flush=True)
        if rate > best[0]:
            best = (rate, (k_sub, inflight))

if best[1] is not None:
    print(f"BEST: k_sub={best[1][0]} in_flight={best[1][1]} "
          f"{best[0]:.1f} Mkeys/s")
else:
    print("BEST: no configuration produced a nonzero rate")
