"""Multi-host distribution tests.

Single-process degenerate behavior runs inline; the REAL multi-process
path (jax.distributed.initialize + cross-process mesh collectives +
process-0-only checkpointing) runs as a 2-process CPU cluster spawned via
scripts/distributed_worker.py -- 4 virtual devices per process, gloo
collectives, one global 8-device mesh."""

import json
import os
import socket
import subprocess
import sys

import pytest

from vgen_tpu.parallel import distributed


def test_initialize_noop_without_cluster_env(monkeypatch):
    for k in distributed._AUTO_ENV_HINTS + ("VGEN_COORDINATOR",):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert distributed.is_initialized() is False
    assert distributed.is_multi_host() is False
    assert distributed.process_index() == 0


def test_initialize_false_hint_stays_single_host(monkeypatch):
    # a cloud scheduler's variables are not a cluster bootstrap: without
    # VGEN_COORDINATOR or JAX_COORDINATOR_ADDRESS, stay single-host
    for k in distributed._AUTO_ENV_HINTS + ("VGEN_COORDINATOR",):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SLURM_JOB_ID", "1")
    assert distributed.initialize() is False
    assert distributed.is_initialized() is False


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_mesh_scan(tmp_path):
    """End-to-end 2-process range scan: every process must see every match
    (all_gather), report identical global ops (psum semantics), and only
    process 0 may write the checkpoint."""
    worker = os.path.join(
        os.path.dirname(__file__), "..", "scripts", "distributed_worker.py"
    )
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            VGEN_COORDINATOR=f"localhost:{port}",
            VGEN_NUM_PROCESSES="2",
            VGEN_PROCESS_ID=str(pid),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=(
                "--xla_force_host_platform_device_count=4 "
                "--xla_backend_optimization_level=0"
            ),
        )
        out = tmp_path / f"out{pid}.json"
        ckpt = tmp_path / f"ckpt{pid}.json"
        procs.append(
            (
                subprocess.Popen(
                    [sys.executable, worker, str(out), str(ckpt)],
                    env=env,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                ),
                out,
                ckpt,
            )
        )
    results = []
    for p, out, ckpt in procs:
        stdout, _ = p.communicate(timeout=900)
        assert p.returncode == 0, stdout.decode()[-4000:]
        results.append((json.loads(out.read_text()), ckpt))

    for r, _ in results:
        assert r["process_count"] == 2
        assert r["global_devices"] == 8
        assert r["local_devices"] == 4
        assert r["n_mesh_devices"] == 8
        # every process re-derives the planted match from the all-gathered
        # indices
        assert r["matches"] == [r["expected_key_hex"]]
        assert r["operations"] == 0x1000  # full range scanned

    # process 0 wrote its checkpoint; process 1's gate kept its path empty
    (r0, ckpt0), (r1, ckpt1) = sorted(
        results, key=lambda rc: rc[0]["process_id"]
    )
    assert r0["ckpt_exists"] is True
    assert r1["ckpt_exists"] is False
