"""Multi-device scanning: shard_map over a device mesh.

Distribution story (SURVEY.md §2.3): the key space is data-parallel across
devices -- device d of N scans k_sub consecutive key windows per
super-batch; the i*G table and the matcher tables are replicated; each
device's packed per-window results are all-gathered (NCCL over NVLink
between the cards of a host) so every process can re-derive every match.
The reference has no distribution at all (single wgpu queue, SURVEY.md
§2.3).

Multi-host: call jax.distributed.initialize() before building the mesh (the
mesh then spans all processes; each host submits its process-local base
points).
"""

from __future__ import annotations

import functools
import time
from typing import Optional, Sequence

import numpy as np

from vgen_tpu.crypto import secp256k1 as ec
from vgen_tpu.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu.pattern import Pattern


def make_mesh(devices=None):
    import jax
    from jax.sharding import Mesh

    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), axis_names=("d",))


def _put_global(arr, sharding):
    """Place a host-identical numpy array onto a (possibly multi-host)
    sharding: every process computes the full array and contributes only
    its addressable shards."""
    import jax

    if jax.process_count() > 1:
        arr = np.asarray(arr)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )
    return jax.device_put(arr, sharding)


_MESHES = {}


@functools.lru_cache(maxsize=8)
def _sharded_step(fmt: AddressFormat, kind: str, glv: bool, chain_len: int,
                  k_sub: int, n_extras: int, mesh_key: int):
    """shard_map the packed scan step (pipeline.packed_scan_fn) over the
    mesh: each device scans its own k_sub windows, and the packed (k_sub,
    34) results are all-gathered so every host can drain every window.

    Returns jitted fn(bx (D*K, 16), by, tx, ty, remaining (D*K,), *margs,
    *extras) -> (D, K, 34) int32 packed results."""
    import jax
    from jax.sharding import PartitionSpec as P

    from vgen_tpu.ops import pipeline

    step = pipeline.packed_scan_fn(fmt, kind, glv, chain_len, k_sub)
    n_margs = 2 if kind == "range" else 3

    def local(*args):
        return jax.lax.all_gather(step(*args), "d")

    return jax.jit(jax.shard_map(
        local,
        mesh=_MESHES[mesh_key],
        in_specs=(P("d"), P("d"), P(), P(), P("d"))
        + (P(),) * (n_margs + n_extras),
        out_specs=P(),
        check_vma=False,
    ))


class MeshScanner:
    """Data-parallel scanner over all devices of a mesh.

    Same scan() protocol as scan.scanner.DeviceScanner, with a key-space
    stride of n_devices * k_sub * batch per super-batch; scan.route picks
    the compiled step per platform.
    """

    def __init__(
        self,
        fmt: AddressFormat,
        batch_size: int = 262_144,
        chain_len: Optional[int] = None,
        mesh=None,
        k_sub: Optional[int] = None,
    ):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from vgen_tpu.scan import route, tables
        from vgen_tpu.scan.scanner import CHAIN_LEN

        self.fmt = fmt
        self.batch = batch_size
        self.chain_len = min(chain_len or CHAIN_LEN, batch_size)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_devices = self.mesh.devices.size
        _MESHES[id(self.mesh)] = self.mesh
        self._mesh_key = id(self.mesh)
        dev0 = self.mesh.devices.flat[0]
        self.platform = route.check_platform(dev0.platform)
        self.k_sub = route.windows_per_dispatch(
            self.platform, k_sub or route.GPU_K_SUB
        )

        replicated = NamedSharding(self.mesh, P())
        tx, ty = tables.ig_table_limbs(batch_size)
        self.tx = _put_global(np.asarray(tx), replicated)
        self.ty = _put_global(np.asarray(ty), replicated)
        self.extras = ()
        if fmt == AddressFormat.P2TR:
            wt = tables.window_table_u32(8)
            self.extras = (_put_global(np.asarray(wt), replicated),)
        self._sharding_d = NamedSharding(self.mesh, P("d"))
        self._single_tables = None  # lazy single-device tables for
        # >TOP_K overflow recovery (see _full_window_indices)

    def _bases(self, base_scalars: Sequence[int]):
        from vgen_tpu.scan.tables import _ints_to_limbs

        xs, ys = [], []
        for s in base_scalars:
            pt = ec.scalar_mult_base_fast(s)
            xs.append(pt[0])
            ys.append(pt[1])
        bx = _put_global(np.asarray(_ints_to_limbs(xs)), self._sharding_d)
        by = _put_global(np.asarray(_ints_to_limbs(ys)), self._sharding_d)
        return bx, by

    def _plan(self, pattern: Pattern, allow_glv: bool):
        """(planned intervals or None, scan.route.Route) for this pattern;
        allow_glv is True for random scans."""
        from vgen_tpu.scan import route

        is_range = not allow_glv
        ivs = route.plan_intervals(pattern, self.fmt, self.batch, is_range)
        return ivs, route.route(
            self.platform, self.fmt, ivs, is_range, self.k_sub
        )

    def windows_per_super(self, pattern: Pattern,
                          allow_glv: bool = False) -> int:
        """Key windows (of self.batch keys) covered by one super-batch."""
        return self.n_devices * self._plan(pattern, allow_glv)[1].k_sub

    def submit_super_batch(self, pattern: Pattern, base_scalar: int,
                           remaining_total: Optional[int] = None,
                           allow_glv: bool = False):
        """Dispatch one super-batch over the mesh WITHOUT blocking on the
        result (JAX async dispatch): returns an opaque handle; pass it to
        drain_packed() (or call run_super_batch) to block.

        Scans keys [base_scalar+1, base_scalar + W*B] where W =
        windows_per_super(pattern): window j (device j//k_sub, slot
        j%k_sub) covers [base_scalar + j*B + 1, base_scalar + (j+1)*B].
        Interval-compilable patterns take the range-compare fast path; with
        allow_glv (random scans) GLV-capable formats check the 6
        endomorphism variants per position (self.glv_active records the
        choice -- the caller must then re-derive all variants of an
        index)."""
        from vgen_tpu.ops import pipeline

        ivs, r = self._plan(pattern, allow_glv)
        self.glv_active = r.glv
        windows = self.n_devices * r.k_sub
        base_scalars = [
            base_scalar + j * self.batch for j in range(windows)
        ]
        bx, by = self._bases(base_scalars)
        if remaining_total is None:
            rem = [self.batch] * windows
        else:
            rem = [
                max(0, min(self.batch, remaining_total - j * self.batch))
                for j in range(windows)
            ]
        rem_dev = _put_global(np.asarray(rem, dtype=np.int32),
                              self._sharding_d)
        step = _sharded_step(
            self.fmt, r.kind, r.glv, self.chain_len, r.k_sub,
            len(self.extras), self._mesh_key,
        )
        packed = step(bx, by, self.tx, self.ty, rem_dev,
                      *pipeline.matcher_args(pattern, self.fmt, ivs),
                      *self.extras)
        if packed.is_fully_addressable:
            # start the tiny result copy now, ahead of the drain
            packed.copy_to_host_async()
        return packed

    @staticmethod
    def drain_packed(handle) -> np.ndarray:
        """Block on a submit_super_batch handle -> (W, 34) int32 packed
        per-window results [count, ops, idx0..15, vbits0..15]."""
        arr = np.asarray(handle)  # (D, K, 34)
        return arr.reshape(-1, arr.shape[-1])

    def _full_window_indices(self, pattern: Pattern, base_scalar: int,
                             remaining: int) -> dict:
        """Complete {match index: variant bitmask} map for one window.

        Overflow recovery (count > TOP_K index slots): re-run the window
        single-device (pipeline.run_window) and pull its whole (batch,)
        match vector.  Uses process-local default-device tables,
        independent of the mesh."""
        import jax.numpy as jnp

        from vgen_tpu.ops import pipeline
        from vgen_tpu.scan import tables
        from vgen_tpu.scan.tables import _ints_to_limbs

        if self._single_tables is None:
            tx, ty = tables.ig_table_arrays(self.batch)
            extras = ()
            if self.fmt == AddressFormat.P2TR:
                extras = (jnp.asarray(tables.window_table_u32(8)),)
            self._single_tables = (tx, ty, extras)
        tx, ty, extras = self._single_tables
        pt = ec.scalar_mult_base_fast(base_scalar)
        bx = jnp.asarray(_ints_to_limbs([pt[0]])[0])
        by = jnp.asarray(_ints_to_limbs([pt[1]])[0])
        ivs, r = self._plan(pattern, self.glv_active)
        _, mask = pipeline.run_window(
            self.fmt, r.kind, bx, by, tx, ty, remaining,
            pipeline.matcher_args(pattern, self.fmt, ivs), extras,
            chain_len=self.chain_len, glv=r.glv,
        )
        m = np.asarray(mask)
        return {int(i): int(m[i]) for i in np.nonzero(m)[0]}

    def run_super_batch(self, pattern: Pattern, base_scalar: int,
                        remaining_total: Optional[int] = None,
                        allow_glv: bool = False):
        """submit_super_batch + block: numpy (per-window counts, indices,
        ops, total_count, total_ops).  One row per key window
        (n_devices * k_sub)."""
        from vgen_tpu.ops import pipeline

        arr = self.drain_packed(self.submit_super_batch(
            pattern, base_scalar, remaining_total, allow_glv
        ))
        return (
            arr[:, 0],
            arr[:, 2:2 + pipeline.TOP_K],
            arr[:, 1],
            int(arr[:, 0].sum()),
            int(arr[:, 1].sum()),
        )

    def scan(
        self,
        pattern: Pattern,
        count: int = 1,
        start: Optional[int] = None,
        end: Optional[int] = None,
        progress_callback=None,
        stop_flag=None,
        max_super_batches: Optional[int] = None,
        checkpoint=None,
        in_flight: int = 2,
    ):
        """Multi-device scan -> scan.scanner.ScanResult.

        Pipelined like scan.scanner.DeviceScanner: up to ``in_flight``
        super-batches are dispatched before the first is drained, so mesh
        compute overlaps host re-derivation (the double-buffering the
        reference does with two GPU frames, gpu.rs:399,973-995).  For range
        scans a scan.checkpoint.CheckpointManager persists the per-mesh
        cursor (contiguous-completed prefix) and found keys."""
        import secrets as _secrets
        from collections import deque

        from vgen_tpu.scan.scanner import (
            ScanResult, StopFlag, _derive_checked, _derive_checked_bulk,
        )

        import jax

        is_range = start is not None
        stride = self.batch * self.windows_per_super(
            pattern, allow_glv=not is_range
        )
        # multi-host: every process sees every match (indices are
        # all-gathered over the mesh), so only process 0 persists cursors
        ckpt = (
            checkpoint
            if is_range and jax.process_index() == 0 else None
        )
        gen = AddressGenerator(self.fmt)
        matches = []
        total_ops = 0
        if is_range:
            next_key = max(start, 2)
            end_key = min(end if end is not None else ec.N - 1, ec.N - 1)
            if ckpt is not None:
                state = ckpt.load()
                if state is not None:
                    next_key = max(next_key, state["next_key"])
                    total_ops = state["operations"]
                    for k in state["match_keys"]:
                        ga = _derive_checked(k, self.fmt, gen)
                        if ga is not None:
                            matches.append(ga)
        else:
            next_key = 2 + _secrets.randbelow(ec.N - stride - 3)
            end_key = None
        stop = stop_flag or StopFlag()
        target = count if count > 0 else float("inf")
        batches = 0
        inflight = deque()
        t0 = time.time()

        def submit():
            nonlocal next_key, batches
            if is_range and next_key > end_key:
                return False
            if max_super_batches is not None and batches >= max_super_batches:
                return False
            base_scalar = next_key - 1
            remaining = end_key - next_key + 1 if is_range else None
            out = self.submit_super_batch(
                pattern, base_scalar, remaining, allow_glv=not is_range
            )
            inflight.append((base_scalar, out))
            batches += 1
            nk = next_key + stride
            if not is_range and nk + 2 * stride >= ec.N:
                # wrap: restart uniformly over the FULL key space (minus
                # headroom for the next super-batch)
                nk = 2 + _secrets.randbelow(ec.N - 2 - 2 * stride)
            next_key = nk
            return True

        def drain_one():
            nonlocal total_ops
            base_scalar, out = inflight.popleft()
            arr = self.drain_packed(out)  # blocks on the super-batch
            total_ops += int(arr[:, 1].sum())
            from vgen_tpu.ops import pipeline as _pl

            K_slots = _pl.TOP_K
            cand_keys = []  # all windows of the super-batch, in order
            # device-confirmed indices collected so far this super-batch
            # (each derives to >= 1 real match); see scan.scanner drain_one
            guaranteed = 0
            for j in range(arr.shape[0]):
                base_d = base_scalar + j * self.batch
                count = int(arr[j, 0])
                pairs = {
                    int(i): int(b)
                    for i, b in zip(
                        arr[j, 2:2 + K_slots],
                        arr[j, 2 + K_slots:2 + 2 * K_slots],
                    )
                    if i >= 0
                }
                idxs = sorted(pairs)
                if count > len(idxs) and (
                    is_range
                    or (
                        target != float("inf")
                        and len(matches) + len(cand_keys)
                        + len(idxs) * (6 if self.glv_active else 1)
                        < target
                    )
                ):
                    # more matches than TOP_K result slots: RANGE scans
                    # always recover (every key must be reported); RANDOM
                    # scans recover only when the truncated slots cannot
                    # reach the requested count (see scan.scanner drain_one)
                    rem_d = (
                        max(0, min(self.batch, end_key - base_d))
                        if is_range else self.batch
                    )
                    pairs = self._full_window_indices(pattern, base_d, rem_d)
                    idxs = sorted(pairs)
                # host-check the masked tx == bx doubling slot
                # (key == 2*base_d; deterministic when base_d <= batch --
                # see scan.scanner drain_one)
                if 1 <= base_d <= self.batch and (
                    not is_range or 2 * base_d <= end_key
                ):
                    dj = base_d - 1
                    if dj not in pairs:
                        pairs[dj] = 0  # bits unknown: check all variants
                        idxs = sorted(pairs)
                    total_ops += 6 if self.glv_active else 1
                pexact = self.fmt in _pl.GLV_EXACT_Y
                if idxs and len(matches) + guaranteed < target:
                    for idx in idxs:
                        key0 = base_d + 1 + idx
                        cand_keys.extend(
                            ec.glv_bit_variant_keys(
                                key0, pairs.get(idx, 0), parity_exact=pexact
                            )
                            if self.glv_active else [key0]
                        )
                    guaranteed += sum(
                        1 for idx in idxs if pairs.get(idx, 0) != 0
                    )
            # one threaded native call for the whole super-batch's
            # candidates (see scan.scanner drain_one)
            for key, ga in _derive_checked_bulk(cand_keys, self.fmt, gen):
                if len(matches) >= target:
                    break
                if ga is not None and pattern.matches(ga.address):
                    matches.append(ga)
            if ckpt is not None:
                done_end = base_scalar + stride
                ckpt.advance(
                    min(done_end + 1, end_key + 1), total_ops,
                    [int(m.hex, 16) for m in matches],
                )
            if progress_callback:
                progress_callback(total_ops)

        while True:
            if stop.is_set() or len(matches) >= target:
                break
            while len(inflight) < max(1, in_flight):
                if not submit():
                    break
            if not inflight:
                break  # range exhausted or batch budget reached
            drain_one()

        # drain remaining in-flight batches (their matches still count)
        while inflight and len(matches) < target:
            drain_one()

        if ckpt is not None:
            ckpt.finalize()
        return ScanResult(
            matches=matches, operations=total_ops,
            elapsed_secs=time.time() - t0,
        )
