"""One process of a multi-process (multi-host) mesh scan.

Spawned N times by tests/test_distributed.py (and usable standalone) to
exercise the REAL jax.distributed code path on a CPU cluster: each process
contributes 4 virtual CPU devices to one global mesh, runs the same
MeshScanner range scan, and writes its view of the results to a JSON file.

What this validates (the branches that only execute at process_count > 1):
  - parallel.distributed.initialize() via VGEN_* env vars + gloo collectives
  - parallel.mesh._put_global's jax.make_array_from_callback branch
  - cross-process all_gather in the sharded scan step
  - every process sees every match (indices are all-gathered)
  - only process 0 writes the range-scan checkpoint

Usage:
  VGEN_COORDINATOR=localhost:PORT VGEN_NUM_PROCESSES=2 VGEN_PROCESS_ID=i \
      python scripts/distributed_worker.py OUT.json [CKPT.json]

Timing mode (scripts/distributed_scaling.py): VGEN_TIMED_KEYS=N adds a
fixed-work never-match range scan (compile excluded) and records keys/s
in the output JSON; VGEN_SINGLE=1 runs the same measurement WITHOUT
jax.distributed (the 1-process baseline the 2-process rate is compared
against); VGEN_SKIP_CORRECTNESS=1 skips the planted-match scan.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=4"
if "xla_backend_optimization_level" not in flags:
    flags += " --xla_backend_optimization_level=0"
os.environ["XLA_FLAGS"] = flags.strip()

import jax

from vgen_tpu.parallel import distributed

BATCH = 256
KEY = 0x54321
START, END = 0x54000, 0x54FFF  # 4096 keys = 2 super-batches on 8 devices


def main() -> None:
    out_path = sys.argv[1]
    ckpt_path = sys.argv[2] if len(sys.argv) > 2 else None
    single = os.environ.get("VGEN_SINGLE") == "1"

    if single:
        assert not distributed.is_multi_host()
    else:
        multi = distributed.initialize()  # VGEN_* env vars
        assert multi, "expected a multi-process cluster"
        assert distributed.is_multi_host()

    from vgen_tpu.crypto.address import AddressFormat, AddressGenerator
    from vgen_tpu.parallel.mesh import MeshScanner
    from vgen_tpu.pattern import Pattern

    result = {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": jax.device_count(),
        "local_devices": jax.local_device_count(),
    }

    if os.environ.get("VGEN_SKIP_CORRECTNESS") != "1":
        addr = AddressGenerator(AddressFormat.P2PKH).generate(
            KEY.to_bytes(32, "big")
        ).address
        import re

        pat = Pattern(f"^{re.escape(addr)}$")

        ckpt = None
        if ckpt_path is not None:
            from vgen_tpu.scan.checkpoint import CheckpointManager

            ckpt = CheckpointManager(
                ckpt_path, pattern=pat.original, fmt="p2pkh",
                start=START, end=END, save_interval_secs=0.0,
            )

        sc = MeshScanner(AddressFormat.P2PKH, BATCH)
        res = sc.scan(pat, count=0, start=START, end=END, checkpoint=ckpt)

        result.update({
            "n_mesh_devices": sc.n_devices,
            "matches": sorted(m.hex for m in res.matches),
            "expected_key_hex": KEY.to_bytes(32, "big").hex(),
            "operations": res.operations,
            "ckpt_exists": (
                os.path.exists(ckpt_path) if ckpt_path is not None else None
            ),
        })

    timed_keys = int(os.environ.get("VGEN_TIMED_KEYS", "0"))
    if timed_keys:
        import time

        batch = int(os.environ.get("VGEN_TIMED_BATCH", "4096"))
        sc2 = MeshScanner(AddressFormat.P2PKH, batch)
        pat2 = Pattern("^1CNeverMatchesTiming")
        stride = batch * sc2.n_devices * sc2.k_sub
        s0 = 0x1000000
        # warmup: compile + one full super-batch round
        sc2.scan(pat2, count=0, start=s0, end=s0 + 2 * stride - 1)
        t0 = time.time()
        res2 = sc2.scan(
            pat2, count=0, start=s0, end=s0 + timed_keys - 1
        )
        dt = time.time() - t0
        result["timed"] = {
            "keys": timed_keys,
            "operations": res2.operations,
            "elapsed": dt,
            "keys_per_sec": res2.operations / dt if dt > 0 else 0.0,
            "batch": batch,
            "n_mesh_devices": sc2.n_devices,
        }

    with open(out_path, "w") as f:
        json.dump(result, f)
    print(f"[{jax.process_index()}] ok: {result}", flush=True)


if __name__ == "__main__":
    main()
