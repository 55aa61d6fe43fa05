"""Multi-host distribution: jax.distributed bootstrap for multi-host scans.

The reference has no multi-node/multi-device distribution at all (single
process, single wgpu queue -- SURVEY.md §2.3); this module adds
`jax.distributed.initialize` + a process-spanning `jax.sharding.Mesh`, with
XLA collectives over NCCL (NVLink within a host, the network across hosts).

Usage -- run ONE process per host, each seeing its local gpus:

    VGEN_COORDINATOR=host0:8476 VGEN_NUM_PROCESSES=2 VGEN_PROCESS_ID=0 \
        vgen-tpu generate -p '^1Cat' ...

(or JAX's own JAX_COORDINATOR_ADDRESS with its process-count variables).
After initialization `jax.devices()` spans every device of every host;
parallel.mesh.MeshScanner shards the key space over that global device
list and all-gathers the packed per-device results so every host
re-derives (and can report) every match.  Checkpoint files are written by
process 0 only.
"""

from __future__ import annotations

import os
from typing import Optional

_INITIALIZED = False

# env var that lets jax.distributed.initialize() find its coordinator on
# its own
_AUTO_ENV_HINTS = ("JAX_COORDINATOR_ADDRESS",)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> bool:
    """Initialize jax.distributed for multi-host scanning.

    Explicit args (or VGEN_COORDINATOR / VGEN_NUM_PROCESSES /
    VGEN_PROCESS_ID env vars) bootstrap any cluster; with no args,
    JAX_COORDINATOR_ADDRESS lets JAX bootstrap itself.  Safe to call
    repeatedly.  Returns True iff more than one process participates.

    MUST run before the first JAX backend touch (the CLI calls it from
    resolve_use_device, ahead of jax.devices()).
    """
    global _INITIALIZED
    import jax

    if _INITIALIZED:
        return jax.process_count() > 1

    # CPU clusters need a cross-process collectives backend; the flag is a
    # no-op for gpu backends, and must be set before the backend initializes
    # (verified: 2-process x 4-virtual-device CPU mesh psum over gloo,
    # tests/test_distributed.py)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    coordinator_address = coordinator_address or os.environ.get(
        "VGEN_COORDINATOR"
    )
    if num_processes is None and os.environ.get("VGEN_NUM_PROCESSES"):
        num_processes = int(os.environ["VGEN_NUM_PROCESSES"])
    if process_id is None and os.environ.get("VGEN_PROCESS_ID"):
        process_id = int(os.environ["VGEN_PROCESS_ID"])

    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
        _INITIALIZED = True
        return jax.process_count() > 1

    if any(os.environ.get(k) for k in _AUTO_ENV_HINTS):
        try:
            jax.distributed.initialize()
            _INITIALIZED = True
            return jax.process_count() > 1
        except Exception:
            return False  # hint env was a false positive; stay single-host
    return False


def is_initialized() -> bool:
    return _INITIALIZED


def is_multi_host() -> bool:
    import jax

    return _INITIALIZED and jax.process_count() > 1


def process_index() -> int:
    import jax

    return jax.process_index() if _INITIALIZED else 0
