"""Precomputed device tables (i*G, fixed windows).

The reference computes its i*G table on the GPU once at startup
(shaders/init.wgsl:4-10, one full scalar-mult per thread).  Here the host
builds it incrementally (crypto/secp256k1.ig_table, one affine add per
point, cached on disk as npz) and uploads it: on the gpu that costs a few
seconds, where compiling the on-device construction cold took minutes
(PERF.md).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from vgen_tpu.crypto import secp256k1 as ec

CACHE_DIR = os.environ.get(
    "VGEN_TPU_CACHE", os.path.expanduser("~/.cache/vgen_tpu")
)


def _ints_to_limbs(values, nlimbs: int = 16) -> np.ndarray:
    """Bulk int -> (N, nlimbs) uint16-limbs-in-uint32 conversion via bytes."""
    buf = b"".join(v.to_bytes(2 * nlimbs, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(values), nlimbs)
    return arr.astype(np.uint32)


def ig_table_limbs(count: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tx, ty): (16, count) uint32 limb arrays for [1..count]*G, disk-cached."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"ig_table_{count}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["tx"], z["ty"]
    pts = ec.ig_table(count, start=1)
    tx = _ints_to_limbs([p[0] for p in pts]).T.copy()  # (16, count)
    ty = _ints_to_limbs([p[1] for p in pts]).T.copy()
    np.savez(path, tx=tx, ty=ty)
    return tx, ty


def ig_table_arrays(count: int, device=None):
    """(tx, ty): the host-built table as (16, count) jax arrays on device."""
    import jax

    dev = device or jax.devices()[0]
    tx, ty = ig_table_limbs(count)
    return jax.device_put(tx, dev), jax.device_put(ty, dev)


def window_table_u32(window_bits: int = 8) -> np.ndarray:
    """(32, 256, 2, 16) fixed-window table for t*G, disk-cached."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"window_table_{window_bits}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["tbl"]
    tbl = ec.window_table(window_bits)
    np.savez(path, tbl=tbl)
    return tbl


def step_point(batch: int):
    """Affine batch*G (the per-batch base-point stride)."""
    return ec.scalar_mult(batch)
