"""Multi-process scaling proxy: 2-process vs 1-process CPU-mesh throughput.

BASELINE.md targets >=90% scaling efficiency 1 device -> 1 host -> N hosts.
Without a multi-host gpu cluster this measures a proxy: the SAME total
virtual device count (8) run as one process vs as a 2-process
jax.distributed + gloo cluster (4 devices each), fixed work, compile
excluded.  Cross-process overhead (gloo collectives over localhost,
double host dispatch) is exactly what divides the two rates.

Writes DISTRIBUTED_r{NN}.json (VGEN_ROUND, default 05).  Env: KEYS
(default 2_000_000), BATCH
(default 4096).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.join(os.path.dirname(__file__), "..")
WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")

KEYS = int(os.environ.get("KEYS", 2_000_000))
BATCH = int(os.environ.get("BATCH", 4096))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _base_env(n_local_devices: int) -> dict:
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=(
            f"--xla_force_host_platform_device_count={n_local_devices} "
            "--xla_backend_optimization_level=0"
        ),
        VGEN_SKIP_CORRECTNESS="1",
        VGEN_TIMED_KEYS=str(KEYS),
        VGEN_TIMED_BATCH=str(BATCH),
    )
    # a stale cluster env var must not flip the single-process run into
    # trying to join a cluster
    for k in ("VGEN_COORDINATOR", "VGEN_NUM_PROCESSES", "VGEN_PROCESS_ID"):
        env.pop(k, None)
    return env


def run_single(tmp: str) -> dict:
    out = os.path.join(tmp, "single.json")
    env = _base_env(8)
    env["VGEN_SINGLE"] = "1"
    r = subprocess.run(
        [sys.executable, WORKER, out],
        env=env, capture_output=True, timeout=1800,
    )
    assert r.returncode == 0, r.stdout.decode()[-4000:] + r.stderr.decode()[-4000:]
    with open(out) as f:
        return json.load(f)


def run_two_process(tmp: str) -> list:
    port = _free_port()
    procs = []
    for pid in range(2):
        env = _base_env(4)
        env.update(
            VGEN_COORDINATOR=f"localhost:{port}",
            VGEN_NUM_PROCESSES="2",
            VGEN_PROCESS_ID=str(pid),
        )
        out = os.path.join(tmp, f"p{pid}.json")
        procs.append((
            subprocess.Popen(
                [sys.executable, WORKER, out], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            ),
            out,
        ))
    results = []
    for p, out in procs:
        stdout, _ = p.communicate(timeout=1800)
        assert p.returncode == 0, stdout.decode()[-4000:]
        with open(out) as f:
            results.append(json.load(f))
    return results


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        single = run_single(tmp)
        two = run_two_process(tmp)

    r1 = single["timed"]["keys_per_sec"]
    # the cluster's throughput is total work / the SLOWEST process's wall
    rates2 = [r["timed"] for r in two]
    elapsed2 = max(t["elapsed"] for t in rates2)
    ops2 = rates2[0]["operations"]  # global psum ops, identical views
    r2 = ops2 / elapsed2 if elapsed2 > 0 else 0.0

    out = {
        "work_keys": KEYS,
        "batch": BATCH,
        "single_process": {
            "devices": single["global_devices"],
            "keys_per_sec": r1,
            "elapsed": single["timed"]["elapsed"],
        },
        "two_process": {
            "devices_per_process": two[0]["local_devices"],
            "global_devices": two[0]["global_devices"],
            "keys_per_sec": r2,
            "elapsed": elapsed2,
            "per_process": rates2,
        },
        "efficiency": r2 / r1 if r1 > 0 else 0.0,
    }
    rnd = os.environ.get("VGEN_ROUND", "05")
    path = os.path.join(REPO, f"DISTRIBUTED_r{rnd}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
