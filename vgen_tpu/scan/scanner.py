"""Scan orchestration: device scan loops, CPU fallback, config/result types.

Public surface parity with the reference scanner (scanner.rs:17-82):
ScanConfig / ScanResult / ProgressCallback / scan / scan_with_progress /
benchmark, plus the device path that replaces the reference's GPU loops
(gpu.rs:920-1343).

Device loop structure: the host precomputes one base point k_j*G per batch
(one cheap Python scalar-mult, the same amortization trick as the
reference's key_to_affine, gpu.rs:901-910), keeps 2+ batches in flight
(JAX async dispatch = the reference's double-buffered Frames, gpu.rs:103-114),
and only syncs on a batch's (count, indices, ops) triple -- a few hundred
bytes, vs the reference's 10MB/batch hash readback.
"""

from __future__ import annotations

import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field as dc_field
from typing import Callable, List, Optional

from vgen_tpu.crypto import secp256k1 as ec
from vgen_tpu.crypto.address import AddressFormat, AddressGenerator, GeneratedAddress
from vgen_tpu.pattern import Pattern

# keys per window (gpu.rs:83 uses 512K too) and the Montgomery inversion
# chain length (curve.batch_affine_add): batch / CHAIN_LEN independent
# chains run side by side; the gpu sweep is in PERF.md.
DEFAULT_DEVICE_BATCH = 524_288
DEFAULT_CPU_BATCH = 10_000
CHAIN_LEN = 64

ProgressCallback = Callable[[int], None]


def _derive_checked(key: int, fmt: AddressFormat,
                    gen: AddressGenerator) -> Optional[GeneratedAddress]:
    """Full derivation for one candidate key, fast path.

    Device-reported indices are re-derived on the host as an independent
    correctness gate.  The pure-Python oracle costs ~1-3ms per key, which
    dominated scans of easy patterns (every TOP_K slot filled each
    super-step); the native C++ derivation is ~20us and is still an
    independent implementation.  WIF/hex come from cheap non-EC encoding.
    """
    from vgen_tpu import native

    if not 1 <= key < ec.N:
        return None
    if native.available():
        addr = native.derive_address(key, fmt.value)
        if addr is not None:
            return _ga_from_addr(key, addr, fmt)
    return gen.generate(key.to_bytes(32, "big"))


def _ga_from_addr(key: int, addr: str,
                  fmt: AddressFormat) -> GeneratedAddress:
    """GeneratedAddress from a natively-derived address string (WIF/hex are
    cheap non-EC encodings done here in Python)."""
    from vgen_tpu.crypto.encode import wif_encode

    secret = key.to_bytes(32, "big")
    hexkey = secret.hex()
    if fmt == AddressFormat.ETHEREUM:
        wif = hexkey
    elif fmt == AddressFormat.P2PKH_UNCOMPRESSED:
        wif = wif_encode(secret, False)
    else:
        wif = wif_encode(secret, True)
    return GeneratedAddress(addr, wif, hexkey, fmt)


def _derive_checked_bulk(keys: List[int], fmt: AddressFormat,
                         gen: AddressGenerator):
    """Bulk counterpart of _derive_checked: one native call (threaded C++)
    for the whole candidate list, yielding (key, GeneratedAddress|None)
    pairs in order.  Falls back to the per-key path (which itself falls
    back to the Python oracle) when the native library is unavailable or
    a single derivation failed (e.g. P2TR tweak overflow -- the oracle
    gets the final word, same as _derive_checked)."""
    from vgen_tpu import native

    valid = [k for k in keys if 1 <= k < ec.N]
    addrs = native.derive_addresses(valid, fmt.value) if valid else []
    if addrs is None:  # no native library: per-key fallback
        for k in keys:
            yield k, _derive_checked(k, fmt, gen)
        return
    by_key = dict(zip(valid, addrs))
    for k in keys:
        addr = by_key.get(k)
        if addr is not None:
            yield k, _ga_from_addr(k, addr, fmt)
        elif 1 <= k < ec.N:
            yield k, gen.generate(k.to_bytes(32, "big"))
        else:
            yield k, None


@dataclass
class ScanConfig:
    format: AddressFormat = AddressFormat.P2PKH
    count: int = 1
    threads: Optional[int] = None
    device_batch_size: Optional[int] = None
    cpu_batch_size: Optional[int] = None
    start: Optional[int] = None  # range scan inclusive start key
    end: Optional[int] = None  # range scan inclusive end key
    use_device: bool = True
    in_flight: int = 4  # pipelined dispatches (generalizes the reference's
    # 2 double-buffered Frames)
    checkpoint: Optional[object] = None  # scan.checkpoint.CheckpointManager
    mesh: Optional[bool] = None  # None = auto: shard over all devices when
    # more than one gpu is visible; True/False force it


@dataclass
class ScanResult:
    matches: List[GeneratedAddress] = dc_field(default_factory=list)
    operations: int = 0
    elapsed_secs: float = 0.0

    def rate(self) -> float:
        return self.operations / self.elapsed_secs if self.elapsed_secs > 0 else 0.0


class StopFlag:
    """Shared cancellable flag (the reference's Arc<AtomicBool>)."""

    def __init__(self):
        self._event = threading.Event()

    def set(self):
        self._event.set()

    def is_set(self) -> bool:
        return self._event.is_set()


# ---------------------------------------------------------------------------
# Device scanner
# ---------------------------------------------------------------------------


class DeviceScanner:
    """Holds device-resident tables + compiled steps for one format/batch."""

    def __init__(
        self,
        fmt: AddressFormat,
        batch_size: int = DEFAULT_DEVICE_BATCH,
        chain_len: int = CHAIN_LEN,
        device=None,
        k_sub: int = 8,
    ):
        import jax
        import jax.numpy as jnp

        from vgen_tpu.scan import tables

        self.fmt = fmt
        self.batch = batch_size
        self.chain_len = min(chain_len, batch_size)
        if batch_size % self.chain_len:
            raise ValueError("batch_size must be a multiple of chain_len")
        self.device = device or jax.devices()[0]
        self.k_sub = k_sub

        self.tx, self.ty = tables.ig_table_arrays(batch_size, self.device)
        self.extras = ()
        if fmt == AddressFormat.P2TR:
            wt = tables.window_table_u32(8)
            self.extras = (jax.device_put(jnp.asarray(wt), self.device),)
        self.step_stride = batch_size  # keys per batch

    def scan(
        self,
        pattern: Pattern,
        config: ScanConfig,
        progress_callback: Optional[ProgressCallback] = None,
        stop_flag: Optional[StopFlag] = None,
        recover_overflow: bool = True,
    ) -> ScanResult:
        import jax.numpy as jnp
        import numpy as np

        from vgen_tpu.ops import pipeline
        from vgen_tpu.scan import route as route_mod
        from vgen_tpu.scan.tables import _ints_to_limbs

        is_range = config.start is not None
        ivs = route_mod.plan_intervals(
            pattern, config.format, self.batch, is_range
        )
        route = route_mod.route(
            self.device.platform, config.format, ivs, is_range, self.k_sub
        )
        glv = route.glv
        k_sub = route.k_sub
        # matcher arguments: hash160 interval bounds (anchored prefixes,
        # pattern/intervals.py) or the padded device DFA
        margs = pipeline.matcher_args(pattern, config.format, ivs)
        packed_step = pipeline.packed_xla_scan_step(
            config.format, route.kind, glv, self.chain_len, k_sub
        )

        ckpt = config.checkpoint if is_range else None
        resume_ops = 0
        resume_matches: List[GeneratedAddress] = []
        if is_range:
            next_key = max(config.start or 1, 1)
            end_key = config.end if config.end is not None else ec.N - 1
            end_key = min(end_key, ec.N - 1)
            if ckpt is not None:
                state = ckpt.load()
                if state is not None:
                    next_key = max(next_key, state["next_key"])
                    resume_ops = state["operations"]
                    _gen = AddressGenerator(config.format)
                    for k in state["match_keys"]:
                        ga = _derive_checked(k, config.format, _gen)
                        if ga is not None:
                            resume_matches.append(ga)
        else:
            # random start, then sequential (the reference GPU scan does the
            # same: one random start per run, gpu.rs:936-945)
            next_key = 2 + secrets.randbelow(ec.N - 3)
            end_key = None

        t0 = time.time()
        gen = AddressGenerator(config.format)
        matches: List[GeneratedAddress] = list(resume_matches)
        total_ops = resume_ops
        inflight = deque()
        stop = stop_flag or StopFlag()
        target = config.count if config.count > 0 else float("inf")

        # a scan window covers keys base+1 .. base+B with base = next_key-1,
        # so key 1 (base 0 = infinity) gets a host-side check instead
        if is_range and next_key == 1:
            ga = gen.generate((1).to_bytes(32, "big"))
            total_ops += 1
            if ga is not None and pattern.matches(ga.address):
                matches.append(ga)
            next_key = 2

        def submit():
            nonlocal next_key
            if is_range and next_key > end_key:
                return False
            n_sub = k_sub
            base_scalars = []
            remainings = []
            for k in range(n_sub):
                window_start = next_key + k * self.batch
                base_scalars.append(window_start - 1)  # keys are base+1+idx
                if is_range:
                    remainings.append(
                        max(0, min(self.batch, end_key - window_start + 1))
                    )
                else:
                    remainings.append(self.batch)
            assert base_scalars[0] >= 1
            pts = [ec.scalar_mult_base_fast(s) for s in base_scalars]
            bx = jnp.asarray(_ints_to_limbs([p[0] for p in pts]))
            by = jnp.asarray(_ints_to_limbs([p[1] for p in pts]))
            rem = jnp.asarray(remainings, dtype=jnp.int32)
            # self.extras is () except P2TR (the window table)
            packed, masks = packed_step(
                bx, by, self.tx, self.ty, rem, *margs, *self.extras
            )
            # start the tiny (K, 34) device->host copy now, so the drain's
            # np.asarray does not wait for it behind later dispatches
            packed.copy_to_host_async()
            inflight.append((base_scalars, packed, masks))
            nk = next_key + self.batch * n_sub
            if not is_range and nk + self.batch * (n_sub + 1) >= ec.N:
                # wrap: restart uniformly over the FULL key space (minus
                # headroom for the next super-batch)
                nk = 2 + secrets.randbelow(
                    ec.N - 2 - self.batch * (n_sub + 1)
                )
            next_key = nk
            return True

        def full_window_indices(masks, k):
            """Complete {match index: variant bitmask} map for window k.

            Overflow recovery: the packed result carries only TOP_K index
            slots; when count exceeds them the window's whole (batch,)
            match vector ships to the host from the dispatch's own masks,
            which stay on the device otherwise (the reference reports every
            match per batch, gpu.rs:1030-1093)."""
            mask = np.asarray(masks[k])
            return {int(i): int(mask[i]) for i in np.nonzero(mask)[0]}

        def drain_one():
            nonlocal total_ops
            base_scalars, packed, masks = inflight.popleft()
            arr = np.asarray(packed)  # ONE transfer: (K, [count, ops, idx...])
            K_slots = pipeline.TOP_K
            cand_keys: List[int] = []  # all K windows, in window/idx order
            # device-confirmed indices collected so far this super-batch:
            # each is >= 1 real match once derived, so the gates below see
            # progress within the super-batch instead of a stale
            # len(matches) (ADVICE r4: the old per-window code appended
            # matches before the next window's gates ran)
            guaranteed = 0
            for k, base_scalar in enumerate(base_scalars):
                count = int(arr[k, 0])
                total_ops += int(arr[k, 1])
                pairs = {
                    int(i): int(b)
                    for i, b in zip(
                        arr[k, 2:2 + K_slots],
                        arr[k, 2 + K_slots:2 + 2 * K_slots],
                    )
                    if i >= 0
                }
                idxs = sorted(pairs)
                if count > len(idxs) and recover_overflow and (
                    is_range
                    or (
                        target != float("inf")
                        and len(matches) + len(cand_keys)
                        + len(idxs) * (6 if glv else 1)
                        < target
                    )
                ):
                    # recovery gate (random-only branch) is OPTIMISTIC:
                    # len(cand_keys) counts every candidate collected so
                    # far as a prospective match, like the idxs*6 term
                    # more matches than TOP_K result slots.  RANGE scans
                    # must report every key in the range: always fetch the
                    # full window.  RANDOM scans recover only when the
                    # truncated slots cannot reach the requested count --
                    # easy patterns with small counts move on to fresh
                    # windows instead of paying a mask transfer per window.
                    pairs = full_window_indices(masks, k)
                    idxs = sorted(pairs)
                # the device masks the tx == bx doubling slot (key == 2*base)
                # as invalid -- deterministic when base <= batch (tiny-range
                # scans, e.g. low Bitcoin Puzzles), vanishing otherwise.
                # Check that one key on the host so no range key is skipped.
                if 1 <= base_scalar <= self.batch and (
                    not is_range or 2 * base_scalar <= end_key
                ):
                    dj = base_scalar - 1  # key0 = base+1+dj = 2*base
                    if dj not in pairs:
                        pairs[dj] = 0  # bits unknown: check all variants
                        idxs = sorted(pairs)
                    total_ops += 6 if glv else 1
                # collection gate is CONSERVATIVE (range scans must report
                # matches in key order): `guaranteed` counts only
                # device-confirmed indices, each of which derives to >= 1
                # real match ahead of this window in cand_keys order
                if idxs and len(matches) + guaranteed < target:
                    pexact = config.format in pipeline.GLV_EXACT_Y
                    for idx in idxs:
                        key0 = base_scalar + 1 + idx
                        cand_keys.extend(
                            ec.glv_bit_variant_keys(
                                key0, pairs.get(idx, 0), parity_exact=pexact
                            )
                            if glv else [key0]
                        )
                    # device-confirmed entries carry nonzero bits (vbits=1
                    # non-GLV, variant mask on GLV); the host-added
                    # doubling-slot entry (bits 0) is unconfirmed
                    guaranteed += sum(
                        1 for idx in idxs if pairs.get(idx, 0) != 0
                    )
            # host-side re-derivation doubles as a device-correctness check
            # (the reference gets the same property by encoding GPU hashes
            # with an independent crate, SURVEY.md §4).  All of the
            # super-batch's candidates go through ONE threaded native call
            # -- easy patterns fill TOP_K slots every window, and a per-key
            # Python/ctypes loop here would hold the device back.
            for key, ga in _derive_checked_bulk(
                cand_keys, config.format, gen
            ):
                if len(matches) >= target:
                    break
                if ga is not None and pattern.matches(ga.address):
                    matches.append(ga)
            if ckpt is not None:
                # keys below the end of this drained window are now complete
                done_end = base_scalars[-1] + self.batch
                ckpt.advance(
                    min(done_end + 1, end_key + 1), total_ops,
                    [int(m.hex, 16) for m in matches],
                )
            if progress_callback:
                progress_callback(total_ops)

        while True:
            if stop.is_set() or len(matches) >= target:
                break
            # keep the pipeline full
            while len(inflight) < max(1, config.in_flight):
                if not submit():
                    break
            if not inflight:
                break  # range exhausted
            drain_one()

        # drain remaining in-flight batches (their matches still count)
        while inflight and len(matches) < target:
            drain_one()

        if ckpt is not None:
            ckpt.finalize()
        return ScanResult(
            matches=matches[: config.count if config.count > 0 else None],
            operations=total_ops,
            elapsed_secs=time.time() - t0,
        )


# ---------------------------------------------------------------------------
# CPU fallback scanner (oracle-based; parity: scanner.rs:76-330)
# ---------------------------------------------------------------------------


def _scan_cpu(
    pattern: Pattern,
    config: ScanConfig,
    progress_callback: Optional[ProgressCallback],
    stop_flag: Optional[StopFlag],
) -> ScanResult:
    from vgen_tpu import native

    if native.available():
        return _scan_cpu_native(
            pattern, config, progress_callback, stop_flag
        )
    return _scan_cpu_python(pattern, config, progress_callback, stop_flag)


def _scan_cpu_native(
    pattern: Pattern,
    config: ScanConfig,
    progress_callback: Optional[ProgressCallback],
    stop_flag: Optional[StopFlag],
) -> ScanResult:
    """C++ scanner path (vgen_tpu/native): the counterpart of the
    reference's rayon CPU scan (scanner.rs:76-330), ~1M+ keys/s."""
    import ctypes
    import secrets as _secrets

    from vgen_tpu import native

    t0 = time.time()
    gen = AddressGenerator(config.format)
    matches: List[GeneratedAddress] = []
    ops = 0
    stop = stop_flag or StopFlag()
    target = config.count if config.count > 0 else float("inf")
    chunk = max(config.cpu_batch_size or 262_144, 4096)
    scanner = native.NativeScanner(batch=1024)
    dfa = pattern.char_dfa
    n_threads = config.threads or 0
    stop_buf = (ctypes.c_int * 1)(0)
    done = threading.Event()

    def _watch():  # propagate StopFlag into the C++ scan mid-call
        while not done.is_set():
            if stop.is_set():
                stop_buf[0] = 1
                return
            time.sleep(0.05)

    watcher = threading.Thread(target=_watch, daemon=True)
    watcher.start()

    is_range = config.start is not None
    ckpt = config.checkpoint if is_range else None
    if is_range:
        key = max(config.start, 1)
        end_key = min(
            config.end if config.end is not None else ec.N - 1, ec.N - 1
        )
        if ckpt is not None:
            state = ckpt.load()
            if state is not None:
                key = max(key, state["next_key"])
                ops = state["operations"]
                for k in state["match_keys"]:
                    ga = _derive_checked(k, config.format, gen)
                    if ga is not None:
                        matches.append(ga)
    else:
        key = None
        end_key = None

    while not stop.is_set() and len(matches) < target:
        if is_range:
            if key > end_key:
                break
            start = key
            n = min(chunk, end_key - key + 1)
            key += n
        else:
            # fresh uniform random START per chunk, sequential keys inside
            # it.  The reference draws every key independently
            # (scanner.rs:128-145); for a uniformly-hashed target the hit
            # distribution is identical (each chunk is a uniformly placed
            # window), and sequential keys let the C++ scanner reuse the
            # incremental point-add instead of a full scalar-mult per key.
            start = 2 + _secrets.randbelow(ec.N - chunk - 3)
            n = chunk
        found, n_ops = scanner.scan(
            start, n, config.format.value, dfa,
            n_threads=n_threads, max_matches=n, stop_buf=stop_buf,
        )
        ops += n_ops
        for k in found:
            if len(matches) >= target:
                break
            ga = _derive_checked(k, config.format, gen)
            if ga is not None and pattern.matches(ga.address):
                matches.append(ga)
        if ckpt is not None and n_ops == n:
            # a stopped chunk is partially scanned -- don't advance past it
            ckpt.advance(start + n, ops, [int(m.hex, 16) for m in matches])
        if progress_callback:
            progress_callback(ops)

    done.set()
    if ckpt is not None:
        ckpt.finalize()
    return ScanResult(
        matches=matches, operations=ops, elapsed_secs=time.time() - t0
    )


def _scan_cpu_python(
    pattern: Pattern,
    config: ScanConfig,
    progress_callback: Optional[ProgressCallback],
    stop_flag: Optional[StopFlag],
) -> ScanResult:
    t0 = time.time()
    gen = AddressGenerator(config.format)
    matches: List[GeneratedAddress] = []
    ops = 0
    stop = stop_flag or StopFlag()
    target = config.count if config.count > 0 else float("inf")
    batch = config.cpu_batch_size or DEFAULT_CPU_BATCH

    if config.start is not None:
        key = max(config.start, 1)
        end_key = config.end if config.end is not None else ec.N - 1
        while key <= end_key and not stop.is_set() and len(matches) < target:
            upper = min(key + batch - 1, end_key)
            for k in range(key, upper + 1):
                ga = gen.generate(k.to_bytes(32, "big"))
                if ga is None:
                    continue
                ops += 1
                if pattern.matches(ga.address):
                    matches.append(ga)
                    if len(matches) >= target:
                        break
            key = upper + 1
            if progress_callback:
                progress_callback(ops)
    else:
        rng = secrets.SystemRandom()
        while not stop.is_set() and len(matches) < target:
            for _ in range(batch):
                k = rng.randrange(1, ec.N)
                ga = gen.generate(k.to_bytes(32, "big"))
                if ga is None:
                    continue
                if pattern.matches(ga.address):
                    matches.append(ga)
                    if len(matches) >= target:
                        break
            ops += batch
            if progress_callback:
                progress_callback(ops)

    return ScanResult(
        matches=matches, operations=ops, elapsed_secs=time.time() - t0
    )


# ---------------------------------------------------------------------------
# Public API (reference parity: scanner.rs:76-96)
# ---------------------------------------------------------------------------

_scanner_cache = {}


def _use_mesh(config: ScanConfig) -> bool:
    """Shard over all gpus when more than one is visible (the reference is
    single-GPU)."""
    if config.mesh is not None:
        return config.mesh
    import jax

    devs = jax.devices()
    return len(devs) > 1 and devs[0].platform == "gpu"


def _scan_mesh(
    pattern: Pattern,
    config: ScanConfig,
    progress_callback: Optional[ProgressCallback],
    stop_flag: Optional[StopFlag],
) -> ScanResult:
    from vgen_tpu.parallel.mesh import MeshScanner

    batch = config.device_batch_size or DEFAULT_DEVICE_BATCH
    key = ("mesh", config.format, batch)
    if key not in _scanner_cache:
        _scanner_cache[key] = MeshScanner(config.format, batch)
    return _scanner_cache[key].scan(
        pattern,
        count=config.count,
        start=config.start,
        end=config.end,
        progress_callback=progress_callback,
        stop_flag=stop_flag,
        checkpoint=config.checkpoint,
        in_flight=max(1, config.in_flight),
    )


def scan_with_progress(
    pattern: Pattern,
    config: ScanConfig,
    progress_callback: Optional[ProgressCallback] = None,
    stop_flag: Optional[StopFlag] = None,
) -> ScanResult:
    """Scan on the JAX device (or the native CPU scanner when
    ``config.use_device`` is off).  A device error propagates."""
    if not config.use_device:
        return _scan_cpu(pattern, config, progress_callback, stop_flag)
    if _use_mesh(config):
        return _scan_mesh(pattern, config, progress_callback, stop_flag)
    batch = config.device_batch_size or DEFAULT_DEVICE_BATCH
    key = (config.format, batch)
    if key not in _scanner_cache:
        _scanner_cache[key] = DeviceScanner(config.format, batch)
    return _scanner_cache[key].scan(
        pattern, config, progress_callback, stop_flag
    )


def scan(pattern: Pattern, config: ScanConfig) -> ScanResult:
    return scan_with_progress(pattern, config)


def benchmark(fmt: AddressFormat, iterations: int = 10_000) -> float:
    """CPU scan-rate calibration for `estimate` (parity: scanner.rs:333-346,
    which times the actual scan hot loop).  Uses the native scanner's real
    multi-threaded rate when available; falls back to the pure-Python
    oracle rate."""
    from vgen_tpu import native

    if native.available():
        from vgen_tpu.pattern.redfa import compile_dfa

        sc = native.NativeScanner(batch=1024)
        dfa = compile_dfa("^1NeverMatchesBenchmark")
        n = max(iterations, 50_000)
        start = 2 + secrets.randbelow(ec.N - n - 3)
        t0 = time.time()
        _, ops = sc.scan(start, n, fmt.value, dfa)
        dt = time.time() - t0
        if dt > 0 and ops:
            return ops / dt
    gen = AddressGenerator(fmt)
    rng = secrets.SystemRandom()
    t0 = time.time()
    for _ in range(iterations):
        gen.generate(rng.randrange(1, ec.N).to_bytes(32, "big"))
    return iterations / (time.time() - t0)


def benchmark_device(
    fmt: AddressFormat = AddressFormat.P2PKH,
    pattern_str: str = "^1BenchNeverMatches",
    batch_size: int = DEFAULT_DEVICE_BATCH,
    min_seconds: float = 5.0,
    warmup_batches: int = 2,
    chain_len: int = CHAIN_LEN,
    k_sub: int = 8,
    ignore_case: bool = False,
) -> dict:
    """Timed device scan (compile excluded) -> keys/s metrics dict.

    recover_overflow=False: the benchmark measures device scan throughput.
    Its count=10**9 is a never-stop sentinel, not a real match budget --
    with recovery on, an easy pattern like "^1C" (~2% of keys) would re-run
    every window through the full-mask step and re-derive millions of
    matches in host Python, measuring the host, not the chip.  Product
    scans (cli/run_search) keep recovery on: each *requested* match must be
    derived and output on the host anyway."""
    pat = Pattern(pattern_str, ignore_case)
    cfg = ScanConfig(format=fmt, count=10**9, device_batch_size=batch_size)
    scanner = DeviceScanner(fmt, batch_size, chain_len=chain_len, k_sub=k_sub)

    # warmup (compile + table upload)
    stop = StopFlag()
    ops_seen = {"n": 0}

    def cb(ops):
        ops_seen["n"] = ops
        if ops >= warmup_batches * batch_size:
            stop.set()

    scanner.scan(pat, cfg, cb, stop, recover_overflow=False)

    stop2 = StopFlag()
    t0 = time.time()

    def cb2(ops):
        if time.time() - t0 >= min_seconds:
            stop2.set()

    res = scanner.scan(pat, cfg, cb2, stop2, recover_overflow=False)
    return {
        "keys_per_sec": res.rate(),
        "operations": res.operations,
        "elapsed": res.elapsed_secs,
        "batch_size": batch_size,
        "format": fmt.value,
    }
