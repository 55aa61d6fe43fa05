"""The device's match masks for one dispatch of key windows vs the host's
independent re-derivation.

The scan pipeline is integer throughout, so the comparison is exact: for
every checked key the device's match bits (1, or the 6-bit GLV variant mask
of ops/pipeline.glv_interval_mask) must equal what the host derives with the
native C++ library (or the pure-Python oracle) and the pattern's regex.
The checked keys are every index the device reported in every window of the
dispatch, plus the first ``n_check`` keys of the first and the last window.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from vgen_tpu.crypto import secp256k1 as ec
from vgen_tpu.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu.pattern import Pattern

# (format, path, pattern): each format once through the interval path (an
# anchored literal prefix whose hash160 intervals are exact) and once
# through the DFA path (an unanchored suffix).  About 1 key in 10^3 matches
# each, so a window carries hundreds of matches to compare.
CASES: Tuple[Tuple[AddressFormat, str, str], ...] = (
    (AddressFormat.P2PKH, "range", "^1Ab"),
    (AddressFormat.P2PKH, "dfa", "ab$"),
    (AddressFormat.P2PKH_UNCOMPRESSED, "range", "^1Ab"),
    (AddressFormat.P2PKH_UNCOMPRESSED, "dfa", "ab$"),
    (AddressFormat.P2SH_P2WPKH, "range", "^3Ab"),
    (AddressFormat.P2SH_P2WPKH, "dfa", "ab$"),
    (AddressFormat.P2WPKH, "range", "^bc1qac"),
    (AddressFormat.P2WPKH, "dfa", "ac$"),
    (AddressFormat.P2TR, "range", "^bc1pac"),
    (AddressFormat.P2TR, "dfa", "ac$"),
    (AddressFormat.ETHEREUM, "range", "^0x12"),
    (AddressFormat.ETHEREUM, "dfa", "ab$"),
)


class OracleMismatch(AssertionError):
    pass


class HostAddresses:
    """Bulk key -> address on the host: the native library when it loaded,
    anchored to the pure-Python oracle on a sample of every batch, else the
    Python oracle alone."""

    def __init__(self, fmt: AddressFormat):
        from vgen_tpu import native

        self.fmt = fmt
        self.gen = AddressGenerator(fmt)
        self.native = native if native.available() else None

    def _python(self, k: int) -> Optional[str]:
        ga = self.gen.generate(k.to_bytes(32, "big"))
        return None if ga is None else ga.address

    def get_many(self, keys: Sequence[int]) -> List[Optional[str]]:
        keys = list(keys)
        addrs = (self.native.derive_addresses(keys, self.fmt.value)
                 if self.native is not None else None)
        if addrs is None:
            return [self._python(k) for k in keys]
        for i in range(0, len(keys), max(1, len(keys) // 8))[:8]:
            want = self._python(keys[i])
            if addrs[i] != want:
                raise OracleMismatch(
                    f"native derivation of key {keys[i]:#x} ({self.fmt.value})"
                    f" gave {addrs[i]}, the Python oracle {want}"
                )
        return [a if a is not None else self._python(k)
                for k, a in zip(keys, addrs)]


def _parity(k: int) -> int:
    return ec.scalar_mult_base_fast(k)[1] & 1


def expected_bits(fmt: AddressFormat, pattern: Pattern, keys0: Sequence[int],
                  glv: bool, host: HostAddresses) -> List[int]:
    """Host match bits per window key, in the device's bit layout.

    Non-GLV: 1 when the key's address matches.  GLV: bit 2v+pi for the
    variant with x = BETA^v * x(kG) and parity index pi, where pi is the
    sign of y for formats that hash both coordinates (GLV_EXACT_Y) and the
    compressed-pubkey prefix parity otherwise (the assignment
    ops/pipeline.glv_variant_symbols documents)."""
    from vgen_tpu.ops import pipeline

    if not glv:
        return [int(a is not None and pattern.matches(a))
                for a in host.get_many(keys0)]
    lams = (1, ec.LAMBDA, ec.LAMBDA2)
    variants = []
    for k in keys0:
        for lam in lams:
            kk = lam * k % ec.N
            variants += [kk, (ec.N - kk) % ec.N]
    hits = [a is not None and pattern.matches(a)
            for a in host.get_many(variants)]
    exact_y = fmt in pipeline.GLV_EXACT_Y
    out = []
    for j, _ in enumerate(keys0):
        bits = 0
        for v in range(3):
            plus, minus = hits[6 * j + 2 * v], hits[6 * j + 2 * v + 1]
            if not (plus or minus):
                continue
            p = 0 if exact_y else _parity(variants[6 * j + 2 * v])
            bits |= ((int(plus) << p) | (int(minus) << (1 - p))) << (2 * v)
        out.append(bits)
    return out


@dataclass
class WindowCheck:
    fmt: AddressFormat
    pattern: str
    kind: str
    glv: bool
    n_windows: int = 1
    first_call_s: float = 0.0
    step_ms: float = 0.0
    n_checked: int = 0
    n_device: int = 0
    n_host: int = 0
    mismatches: List[Tuple[int, int, int]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.mismatches

    def line(self) -> str:
        return (
            f"{self.fmt.value:>18} {self.kind:>5} glv={int(self.glv)} "
            f"{self.pattern!r:12} first call {self.first_call_s:7.2f}s "
            f"step {self.step_ms:8.2f}ms  checked {self.n_checked} keys "
            f"in {self.n_windows} windows, "
            f"device {self.n_device} / host {self.n_host} matches, "
            f"{len(self.mismatches)} mismatches"
        )


class WindowRunner:
    """Runs the scanner's own compiled step (pipeline.packed_xla_scan_step,
    k_sub windows from a base) and returns every window's match mask;
    tables are built once.  k_sub: windows per dispatch, by default the
    route's for the device's platform."""

    def __init__(self, batch: int, chain_len: int, device=None,
                 k_sub: Optional[int] = None):
        import jax

        from vgen_tpu.scan import route, tables

        self.batch = batch
        self.chain_len = min(chain_len, batch)
        self.device = device or jax.devices()[0]
        self.k_sub = k_sub or route.windows_per_dispatch(self.device.platform)
        self.tx, self.ty = tables.ig_table_arrays(batch, self.device)
        self._wt = None

    def extras(self, fmt: AddressFormat):
        import jax
        import jax.numpy as jnp

        from vgen_tpu.scan import tables

        if fmt != AddressFormat.P2TR:
            return ()
        if self._wt is None:
            self._wt = jax.device_put(
                jnp.asarray(tables.window_table_u32(8)), self.device
            )
        return (self._wt,)

    def prepare(self, fmt: AddressFormat, pattern: Pattern, base: int,
                is_range: bool = False):
        """(route, jitted step, its arguments) for k_sub windows from base:
        the step a scan of this pattern dispatches."""
        import jax.numpy as jnp

        from vgen_tpu.ops import pipeline
        from vgen_tpu.scan import route as route_mod
        from vgen_tpu.scan.tables import _ints_to_limbs

        ivs = route_mod.plan_intervals(pattern, fmt, self.batch, is_range)
        route = dataclasses.replace(
            route_mod.route(self.device.platform, fmt, ivs, is_range),
            k_sub=self.k_sub,
        )
        margs = pipeline.matcher_args(pattern, fmt, ivs)
        K = route.k_sub
        pts = [ec.scalar_mult_base_fast(base + k * self.batch)
               for k in range(K)]
        step = pipeline.packed_xla_scan_step(
            fmt, route.kind, route.glv, self.chain_len, K
        )
        args = (
            jnp.asarray(_ints_to_limbs([p[0] for p in pts])),
            jnp.asarray(_ints_to_limbs([p[1] for p in pts])),
            self.tx, self.ty, jnp.full((K,), self.batch, dtype=jnp.int32),
            *margs, *self.extras(fmt),
        )
        return route, step, args

    def mask(self, fmt: AddressFormat, pattern: Pattern, base: int):
        """(route, (K, batch) int32 masks) for the K windows of a random
        scan from base: window k covers keys base + k*batch + 1 ..
        base + (k+1)*batch."""
        route, step, args = self.prepare(fmt, pattern, base)
        return route, step(*args)[1]


def check_window(runner: WindowRunner, fmt: AddressFormat, pattern_str: str,
                 base: int, n_check: int) -> WindowCheck:
    """Compare one dispatch's device masks with the host re-derivation of
    every key the device reported in any window, and of the first n_check
    keys of the first and the last window.  Mismatches are (flat index
    k*batch + i, device bits, host bits)."""
    import numpy as np

    pattern = Pattern(pattern_str)
    t0 = time.perf_counter()
    route, masks = runner.mask(fmt, pattern, base)
    masks.block_until_ready()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner.mask(fmt, pattern, base)[1].block_until_ready()
    step = time.perf_counter() - t0
    flat = np.asarray(masks).reshape(-1)
    B = runner.batch
    K = flat.shape[0] // B
    reported = np.nonzero(flat)[0]
    head = range(min(n_check, B))
    idxs = sorted({int(i) for i in reported} | set(head)
                  | {(K - 1) * B + i for i in head})
    want = expected_bits(fmt, pattern, [base + 1 + j for j in idxs],
                         route.glv, HostAddresses(fmt))
    res = WindowCheck(fmt, pattern_str, route.kind, route.glv, K, first,
                      step * 1e3, len(idxs), len(reported),
                      sum(1 for w in want if w))
    for j, w in zip(idxs, want):
        if int(flat[j]) != w:
            res.mismatches.append((j, int(flat[j]), w))
    return res


def check_cases(runner: WindowRunner, cases=CASES, base: Optional[int] = None,
                n_check: int = 65_536) -> Dict[Tuple[str, str], WindowCheck]:
    """check_window for every (format, path, pattern) case, one shared
    random window base."""
    import secrets

    if base is None:
        base = 2 + secrets.randbelow(ec.N - 2 * runner.batch)
    return {
        (fmt.value, path): check_window(runner, fmt, pat, base, n_check)
        for fmt, path, pat in cases
    }
