"""Per-format x per-path benchmark matrix on the local gpu.

Times the DeviceScanner end-to-end loop (compile excluded) for every
address format on both match paths:

- "interval": anchored-literal prefix -> hash160/account/output-key range
  compare (the VanitySearch-style fast path; GLV 6-keys-per-add for the
  formats that support it)
- "dfa": generic regex with a selective literal prefix -- the
  hybrid pre-filter routes these down the interval fast path with
  host-side regex filtering of survivors, so this row now measures what
  a user actually gets for such patterns
- "dfa-pure": a pattern whose prefix is too weak for the pre-filter
  (leading wildcard) -> the full on-device encode + DFA matcher

The reference benchmarks only batch-size sweeps of its two GPU paths
(benches/gpu_bench.rs:24-52) and never ran Ethereum on the GPU at all;
its P2TR path tweaks per-candidate on the CPU (gpu.rs:1282-1291).

Writes BENCH_MATRIX.json at the repo root.  Env: SECS (default 6),
B (default 524288), B_P2TR (default 131072).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from vgen_tpu import compile_cache

compile_cache.enable()

from vgen_tpu.crypto.address import AddressFormat
from vgen_tpu.scan.scanner import CHAIN_LEN, benchmark_device

SECS = float(os.environ.get("SECS", 6))
B = int(os.environ.get("B", 524_288))
B_P2TR = int(os.environ.get("B_P2TR", 524_288))

# (format, interval pattern, class pattern, pure-dfa pattern, batch) --
# patterns are never-match, charset-valid prefixes.  The class pattern's
# selective prefix triggers the hybrid interval pre-filter; the pure-dfa
# pattern's wildcard head defeats it so the on-device DFA matcher runs.
CASES = [
    (AddressFormat.P2PKH, "^1CBenchNeverMatchesXx", "^1C[ab]NeverMatches",
     "^1.C.NeverMatches", B),
    (AddressFormat.P2PKH_UNCOMPRESSED, "^1UBenchNeverMatchXy",
     "^1U[ab]NeverMatch", "^1.U.NeverMatch", B),
    (AddressFormat.P2SH_P2WPKH, "^3JBenchNeverMatchXy", "^3J[ab]NeverMatch",
     "^3.J.NeverMatch", B),
    (AddressFormat.P2WPKH, "^bc1qzzzzzzzzzzzz", "^bc1qz[z9]zzzzzzzz",
     "^bc1q.z.zzzzzzzz", B),
    (AddressFormat.ETHEREUM, "^0xdeadbeefcafe0123", "^0xdead[bc]eefcafe",
     "^0x.dead.eefcafe", B),
    (AddressFormat.P2TR, "^bc1pzzzzzzzzzzzz", "^bc1pz[z9]zzzzzzzz",
     "^bc1p.z.zzzzzzzz", B_P2TR),
]

rows = []
for fmt, iv_pat, dfa_pat, pure_pat, batch in CASES:
    for kind, pat in (("interval", iv_pat), ("dfa", dfa_pat),
                      ("dfa-pure", pure_pat)):
        t0 = time.time()
        stats = benchmark_device(
            fmt, pattern_str=pat, batch_size=batch, min_seconds=SECS,
            chain_len=min(CHAIN_LEN, batch), k_sub=8,
        )
        rate = stats["keys_per_sec"]
        rows.append({
            "format": fmt.value,
            "path": kind,
            "pattern": pat,
            "batch": batch,
            "keys_per_sec": rate,
            "vs_baseline_2M": rate / 2e6,
        })
        print(f"{fmt.value:22s} {kind:8s} {rate/1e6:9.2f} Mkeys/s "
              f"(wall {time.time()-t0:.0f}s)", flush=True)
        out = {
            "device": jax.devices()[0].device_kind,
            "seconds_per_cell": SECS,
            "rows": rows,
        }
        # write incrementally: a mid-run death keeps the finished cells
        with open(os.path.join(os.path.dirname(__file__), "..",
                               "BENCH_MATRIX.json"), "w") as f:
            json.dump(out, f, indent=1)

print(json.dumps(out))
