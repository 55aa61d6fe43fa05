"""Fused per-format scan pipelines: EC point -> hash -> encode -> DFA match.

This is the device-side replacement for the reference's per-batch host loop
(gpu.rs:1030-1093: readback 512K hash160s, rayon-encode, regex-match).  Here
a single jitted step turns a batch of table points + one base point into a
match count and top-K matching indices; the host only ever sees those.

Formats (parity: reference AddressFormat, address.rs:11-24):
  p2pkh / p2pkh-uncompressed / p2sh-p2wpkh  -> Base58Check digit symbols
  p2wpkh / p2tr                             -> bech32(m) digit symbols
  ethereum                                  -> EIP-55 cased-hex symbols
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vgen_tpu.crypto.address import AddressFormat
from vgen_tpu.ops import curve, encode, field, keccak, sha256, u256

U32 = jnp.uint32
TOP_K = 16  # fixed result slots per batch (SURVEY.md §7 hard part (d))


def match_symbols(dfa_flat, dfa_accept, start, width: int, syms, length):
    """Run the projected DFA over (T,*B) symbols with EOS/PAD overlay.

    dfa_flat: (S*width,) int32 flattened transition table.
    width = n_digits + 2; EOS = width-2, PAD = width-1.

    One table gather per symbol: the int32 state is the only per-key
    carry, and the table (at most a few hundred states x 60 symbols) stays
    in cache.  Returns (*B,) int32 accept flags."""
    T = syms.shape[0]
    B = syms.shape[1:]
    eos = jnp.int32(width - 2)
    pad = jnp.int32(width - 1)

    def body(j, state):
        row = jax.lax.dynamic_index_in_dim(
            syms, jnp.minimum(j, T - 1), 0, keepdims=False
        )
        sym = jnp.where(j < length, row, jnp.where(j == length, eos, pad))
        return dfa_flat[state * width + sym]

    state0 = jnp.full(B, start, dtype=jnp.int32)
    state = jax.lax.fori_loop(0, T + 1, body, state0)
    return dfa_accept[state]


def compressed_pubkey_bytes(x, y):
    """(16,*B) affine coords -> (33,*B) SEC1 compressed serialization."""
    parity = y[0] & jnp.uint32(1)
    prefix = (jnp.uint32(2) + parity)[None]
    return jnp.concatenate([prefix, u256.to_bytes_be(x)], axis=0)


def uncompressed_pubkey_bytes(x, y):
    """(16,*B) affine coords -> (65,*B) SEC1 uncompressed serialization."""
    four = jnp.full((1,) + x.shape[1:], 4, dtype=U32)
    return jnp.concatenate(
        [four, u256.to_bytes_be(x), u256.to_bytes_be(y)], axis=0
    )


def _base58_payload(version: int, h160):
    v = jnp.full((1,) + h160.shape[1:], version, dtype=U32)
    return jnp.concatenate([v, h160], axis=0)


def symbols_p2pkh(x, y, b58_basis=None):
    h160 = encode.hash160_33(compressed_pubkey_bytes(x, y))
    return encode.base58check_symbols(_base58_payload(0, h160), b58_basis)


def symbols_p2pkh_uncompressed(x, y, b58_basis=None):
    h160 = encode.hash160_65(uncompressed_pubkey_bytes(x, y))
    return encode.base58check_symbols(_base58_payload(0, h160), b58_basis)


def symbols_p2wpkh(x, y, b58_basis=None):
    h160 = encode.hash160_33(compressed_pubkey_bytes(x, y))
    return encode.segwit_symbols(h160, 0)


def symbols_p2sh_p2wpkh(x, y, b58_basis=None):
    h160 = encode.hash160_33(compressed_pubkey_bytes(x, y))
    return encode.base58check_symbols(
        _base58_payload(5, script_hash(h160)), b58_basis
    )


def symbols_ethereum(x, y):
    return encode.eth_symbols(eth_account(x, y))


_SYMBOLS = {
    AddressFormat.P2PKH: symbols_p2pkh,
    AddressFormat.P2PKH_UNCOMPRESSED: symbols_p2pkh_uncompressed,
    AddressFormat.P2WPKH: symbols_p2wpkh,
    AddressFormat.P2SH_P2WPKH: symbols_p2sh_p2wpkh,
    AddressFormat.ETHEREUM: symbols_ethereum,
}

_TAPTWEAK_MIDSTATE = sha256.tagged_midstate("TapTweak")


def p2tr_output_key(x, y, window_table):
    """Taproot output key: even-Y normalize, TapTweak on device, Q = P + t*G.

    The reference computes the tweak per candidate on the CPU
    (gpu.rs:1282-1291); here the windowed ladder keeps it on the device.
    Returns (qx (16,*B) limbs, ok mask)."""
    B = x.shape[1:]
    y_even = u256.select(y[0] & jnp.uint32(1) == 0, y, field.neg(y))
    xb = u256.to_bytes_be(x)
    t_bytes = sha256.tagged_hash_32(_TAPTWEAK_MIDSTATE, xb)
    t_limbs = u256.from_bytes_be(t_bytes)
    # BIP341: t must be < n (negligible failure probability, still masked)
    n_limbs = u256.constant(field.N_INT, B)
    t_ok = ~u256.geq(t_limbs, n_limbs)
    qx, _, q_ok = curve.scalar_mul_add_windowed_affine(
        t_limbs, window_table, x, y_even, 8
    )
    return qx, t_ok & q_ok


def symbols_p2tr(x, y, window_table, valid):
    """P2TR bech32m symbols.  Returns (syms, length, valid&tweak_valid)."""
    qx, ok = p2tr_output_key(x, y, window_table)
    syms, length = encode.segwit_symbols(u256.to_bytes_be(qx), 1)
    return syms, length, valid & ok


class StepResult(NamedTuple):
    count: jnp.ndarray  # () int32 -- number of matches in batch
    indices: jnp.ndarray  # (TOP_K,) int32 -- match indices, -1 padded
    ops: jnp.ndarray  # () int32 -- valid keys scanned
    vbits: jnp.ndarray  # (TOP_K,) int32 -- per-index GLV variant bitmask
    # (bit 2v+pi, see glv_interval_mask); 1 on non-GLV paths, 0 padded


# DFA width (n_digits + 2) is a per-format constant; state count is padded to
# a bucket so one compiled step serves every pattern of a format.
FORMAT_DFA_WIDTH = {
    AddressFormat.P2PKH: 60,
    AddressFormat.P2PKH_UNCOMPRESSED: 60,
    AddressFormat.P2SH_P2WPKH: 60,
    AddressFormat.P2WPKH: 34,
    AddressFormat.P2TR: 34,
    AddressFormat.ETHEREUM: 24,
}


def pad_device_dfa(dev, bucket_min: int = 32):
    """Pad a pattern.DeviceDFA to a power-of-two state count.

    Keeps the jitted step's shapes stable across patterns: only the padded
    bucket size changes (rarely), not every new regex."""
    S, W = dev.table.shape
    S2 = max(bucket_min, 1 << (S - 1).bit_length())
    table = np.zeros((S2, W), dtype=np.int32)
    table[:S] = dev.table
    accept = np.zeros((S2,), dtype=np.int32)
    accept[:S] = dev.accept.astype(np.int32)
    return table.reshape(-1), accept


def _compressed_bytes(xv, pi):
    """(33, *B) compressed pubkey bytes with prefix 2 + pi (pi: int or a
    traced (*B,) row)."""
    xb = u256.to_bytes_be(xv)
    prefix = (jnp.full((1,) + xb.shape[1:], 2 + pi, dtype=U32)
              if isinstance(pi, int) else (jnp.uint32(2) + pi)[None])
    return jnp.concatenate([prefix, xb], axis=0)


def glv_variants(fmt: AddressFormat, x3, y3):
    """The 6 GLV variant points of every key, stacked along the first batch
    axis in bit order 2v+pi: (X (16, 6*B0, ...), Y or None, PI row).

    One hash over all six variants keeps the program (and XLA's compile
    time) one variant wide.  X = BETA^v * x; for GLV_EXACT_Y formats Y is
    +y (pi=0) or -y (pi=1), otherwise Y is None and pi is the compressed
    prefix parity."""
    from vgen_tpu.crypto import secp256k1 as ec

    shape = x3.shape[1:]
    xs = (x3, field.mul(x3, u256.constant(ec.BETA, shape)),
          field.mul(x3, u256.constant(ec.BETA2, shape)))
    X = jnp.concatenate([xv for xv in xs for _ in range(2)], axis=1)
    Y = None
    if fmt in GLV_EXACT_Y:
        ny = field.neg(y3)
        Y = jnp.concatenate([y3, ny] * 3, axis=1)
    PI = jnp.concatenate(
        [jnp.full(shape, pi, dtype=U32) for _ in range(3) for pi in (0, 1)],
        axis=0,
    )
    return X, Y, PI


def variant_bits(m):
    """(6*B0, ...) per-variant matches (glv_variants order) -> (B0, ...)
    int32 mask with bit 2v+pi set per matching variant."""
    m = m.reshape((6, m.shape[0] // 6) + m.shape[1:]).astype(jnp.int32)
    shifts = jnp.arange(6, dtype=jnp.int32).reshape((6,) + (1,) * (m.ndim - 1))
    return jnp.sum(m << shifts, axis=0)


def glv_variant_symbols(fmt: AddressFormat, xv, yv, pi, b58_basis=None):
    """Address symbols for one GLV variant point: x-coordinate xv with
    compressed-pubkey parity index pi (prefix byte 2+pi); yv is the ±y
    coordinate (consulted by Ethereum only, which hashes full coords).

    The variant↔(xv, pi) assignment is LOAD-BEARING: the GLV kernels report
    a per-index bitmask with bit 2v+pi set for variant (xv=β^v·x, parity
    pi), and the host derives ONLY the candidates
    crypto.secp256k1.glv_bit_variant_keys maps from those bits.  The
    pairing is pinned by tests/test_glv_bits.py and the oracle check
    (scan/oracle.py) -- do not reorder one side without the other.

    pi: int, or a traced row of parity indices (glv_variants)."""
    if fmt == AddressFormat.ETHEREUM:
        return symbols_ethereum(xv, yv)
    if fmt == AddressFormat.P2PKH_UNCOMPRESSED:
        # full-coordinate hash: yv is the exact ±y (GLV_EXACT_Y), pi only
        # selects which sign the caller passed
        return symbols_p2pkh_uncompressed(xv, yv, b58_basis)
    h160 = encode.hash160_33(_compressed_bytes(xv, pi))
    if fmt == AddressFormat.P2PKH:
        return encode.base58check_symbols(_base58_payload(0, h160), b58_basis)
    if fmt == AddressFormat.P2WPKH:
        return encode.segwit_symbols(h160, 0)
    if fmt == AddressFormat.P2SH_P2WPKH:
        return encode.base58check_symbols(
            _base58_payload(5, script_hash(h160)), b58_basis
        )
    raise ValueError(fmt)


def make_format_mask(fmt: AddressFormat, glv: bool = False):
    """Hash+encode+match mask stage: (x3, y3, valid, dfa_flat, dfa_accept,
    start, remaining, *extras) -> (matchbits (B,) int32, valid (B,) bool).

    ``matchbits`` already includes the validity/remaining mask: 0 = miss;
    on GLV paths the 6-bit variant mask (glv_interval_mask bit layout),
    1 otherwise.  ``valid`` is the ops-counting mask (pre-P2TR-tweak
    refinement, matching how the scan loop reports operations)."""
    width = FORMAT_DFA_WIDTH[fmt]

    def mask(x3, y3, valid, dfa_flat, dfa_accept, start, remaining, *extras):
        B = x3.shape[1]
        idx = jnp.arange(B, dtype=jnp.int32)
        valid = valid & (idx < remaining)

        if glv:
            assert fmt in GLV_FORMATS, fmt
            X, Y, PI = glv_variants(fmt, x3, y3)
            syms, length = glv_variant_symbols(fmt, X, Y, PI)
            m = match_symbols(dfa_flat, dfa_accept, start, width, syms,
                              length)
            return jnp.where(valid, variant_bits(m), 0), valid

        if fmt == AddressFormat.P2TR:
            syms, length, mvalid = symbols_p2tr(x3, y3, extras[0], valid)
        else:
            mvalid = valid
            syms, length = _SYMBOLS[fmt](x3, y3)

        matched = match_symbols(dfa_flat, dfa_accept, start, width, syms,
                                length)
        return (
            jnp.where(matched.astype(bool) & mvalid, jnp.int32(1), 0),
            mvalid,
        )

    return mask


_TOPK_BLOCK = 512


def top_k_match_indices(scores):
    """Exact top-TOP_K of a (B,) int32 score vector (score = index for
    matches, -1 for misses) via a two-stage reduction.

    lax.top_k over the full 512K batch measured 7.4 ms of a ~50 ms scan
    step (round-4 step-split profile).  Stage 1 takes a per-block max
    (one full-width VPU pass) and top-Ks the B/512 block maxima; stage 2
    top-Ks the 16 selected blocks' 8192 raw scores.  Exactness: scores
    are distinct indices or -1, so every block holding one of the global
    top-K has block-max >= the K-th largest score and outranks every
    non-holding block; there are at most K such blocks, so the K selected
    blocks cover the global top-K."""
    B = scores.shape[0]
    if B % _TOPK_BLOCK or B < 2 * _TOPK_BLOCK * TOP_K:
        top, _ = jax.lax.top_k(scores, TOP_K)
        return top
    s2 = scores.reshape(B // _TOPK_BLOCK, _TOPK_BLOCK)
    bmax = jnp.max(s2, axis=1)
    _, bidx = jax.lax.top_k(bmax, TOP_K)
    seg = s2[bidx].reshape(-1)
    top, _ = jax.lax.top_k(seg, TOP_K)
    return top


def mask_to_result(matchbits, valid, ops_mult: int = 1) -> "StepResult":
    """(matchbits, valid) -> packed StepResult (count, top-K, ops, vbits).

    matchbits (B,) int32: 0 = miss; nonzero = match.  On GLV paths the
    value is the 6-bit variant mask (glv_interval_mask bit layout), shipped
    per top-K index so the host derives only the variants that actually
    matched instead of all 6."""
    B = matchbits.shape[0]
    idx = jnp.arange(B, dtype=jnp.int32)
    matched = matchbits > 0
    count = jnp.sum(matched.astype(jnp.int32))
    scores = jnp.where(matched, idx, jnp.int32(-1))
    top = top_k_match_indices(scores)
    vbits = jnp.where(top >= 0, matchbits[jnp.maximum(top, 0)], 0)
    ops = jnp.sum(valid.astype(jnp.int32)) * jnp.int32(ops_mult)
    return StepResult(count=count, indices=top, ops=ops, vbits=vbits)


# packed per-window result row: [count, ops, idx0..15, vbits0..15]
PACKED_WIDTH = 2 + 2 * TOP_K


# ---------------------------------------------------------------------------
# Interval (anchored-prefix) matching: the pattern/intervals.py fast path.
# Matching compares the format's device-checked
# value (hash160 / account bytes / taproot output key) against precompiled
# inclusive [lo, hi] word intervals instead of encode+DFA.
# ---------------------------------------------------------------------------

MAX_INTERVALS = 8  # comparator slots (pattern.intervals.MAX_INTERVALS)

# big-endian u32 words of the compared value, per format
INTERVAL_WORDS = {
    AddressFormat.P2PKH: 5,
    AddressFormat.P2PKH_UNCOMPRESSED: 5,
    AddressFormat.P2SH_P2WPKH: 5,
    AddressFormat.P2WPKH: 5,
    AddressFormat.P2TR: 8,
    AddressFormat.ETHEREUM: 5,
}

# formats where the GLV endomorphism checks 6 keys {±k, ±λk, ±λ²k} per EC
# add (random scans only; see crypto/secp256k1.glv_variant_keys).  P2TR is
# excluded: the TapTweak scalar-mult dominates and is per-variant.
GLV_FORMATS = (
    AddressFormat.P2PKH,
    AddressFormat.P2PKH_UNCOMPRESSED,
    AddressFormat.P2WPKH,
    AddressFormat.P2SH_P2WPKH,
    AddressFormat.ETHEREUM,
)

# GLV formats whose hashed value covers the full (x, y) point, so the ±
# variant pair maps to exact {+y, -y} coordinates instead of the two
# compressed-pubkey parity prefixes.  The device kernels run the full EC
# finish (y needed) and the host resolves variant bits with
# crypto.secp256k1.glv_bit_variant_keys(parity_exact=True): bit 2v+pi is
# exactly key λ^v·k (pi=0, y=+y) or N−λ^v·k (pi=1, y=−y).
GLV_EXACT_Y = (
    AddressFormat.P2PKH_UNCOMPRESSED,
    AddressFormat.ETHEREUM,
)


def intervals_to_words(ivs, n_words: int = 5, n_slots: int = MAX_INTERVALS):
    """Host: [(lo, hi)] ints -> (lo, hi) uint32 arrays (n_slots, n_words),
    big-endian words, padded with empty (lo=1 > hi=0) intervals."""
    lo = np.zeros((n_slots, n_words), dtype=np.uint32)
    hi = np.zeros((n_slots, n_words), dtype=np.uint32)
    lo[:, n_words - 1] = 1  # empty padding: lo > hi never matches
    for j, (l, h) in enumerate(ivs):
        for w in range(n_words):
            sh = 32 * (n_words - 1 - w)
            lo[j, w] = (l >> sh) & 0xFFFFFFFF
            hi[j, w] = (h >> sh) & 0xFFFFFFFF
    return lo, hi


def bytes_be_words(h):
    """(4*W, T) big-endian value bytes -> list of W (T,) u32 word rows."""
    n = h.shape[0] // 4
    return [
        (h[4 * i] << 24) | (h[4 * i + 1] << 16)
        | (h[4 * i + 2] << 8) | h[4 * i + 3]
        for i in range(n)
    ]


def script_hash(h160):
    """hash160(OP_0 OP_PUSH20 <h160>) -- the P2SH-P2WPKH redeem script."""
    B = h160.shape[1:]
    script = jnp.concatenate(
        [
            jnp.zeros((1,) + B, dtype=jnp.uint32),
            jnp.full((1,) + B, 0x14, dtype=jnp.uint32),
            h160,
        ],
        axis=0,
    )
    return encode.hash160_22(script)


def eth_account(x3, y3):
    """(20, T) Ethereum account bytes = keccak256(x||y)[12:]."""
    pub64 = jnp.concatenate(
        [u256.to_bytes_be(x3), u256.to_bytes_be(y3)], axis=0
    )
    return keccak.keccak256_bytes(pub64, 64)[12:32]


def interval_value_words(fmt: AddressFormat, x3, y3, *extras):
    """Format's device-checked value as big-endian u32 word rows (+ok mask
    refinement for P2TR)."""
    ok = None
    if fmt in (AddressFormat.P2PKH, AddressFormat.P2WPKH):
        h = encode.hash160_33(compressed_pubkey_bytes(x3, y3))
    elif fmt == AddressFormat.P2PKH_UNCOMPRESSED:
        h = encode.hash160_65(uncompressed_pubkey_bytes(x3, y3))
    elif fmt == AddressFormat.P2SH_P2WPKH:
        h = script_hash(encode.hash160_33(compressed_pubkey_bytes(x3, y3)))
    elif fmt == AddressFormat.ETHEREUM:
        h = eth_account(x3, y3)
    elif fmt == AddressFormat.P2TR:
        qx, ok = p2tr_output_key(x3, y3, extras[0])
        h = u256.to_bytes_be(qx)
    else:  # pragma: no cover
        raise ValueError(f"interval path does not support {fmt}")
    return bytes_be_words(h), ok


def interval_slot_count(n_ivs: int) -> int:
    """Slots to compile for n_ivs intervals: next power of two (compile-cache
    friendly), capped at MAX_INTERVALS.  Most anchored prefixes need 1-2
    slots; always comparing all 8 wastes ~5% of the GLV kernel."""
    return min(MAX_INTERVALS, max(1, 1 << (n_ivs - 1).bit_length()))


def in_intervals(words, lo, hi):
    """Lexicographic lo <= words <= hi over the (static) slot dimension.

    words: list of W (T,) uint32 rows; lo/hi: (n_slots, W) uint32 bound
    tables."""
    n = len(words)
    matched = None
    for j in range(lo.shape[0]):
        ge = words[n - 1] >= lo[j, n - 1]
        le = words[n - 1] <= hi[j, n - 1]
        for w in range(n - 2, -1, -1):
            lw = lo[j, w]
            hw = hi[j, w]
            ge = (words[w] > lw) | ((words[w] == lw) & ge)
            le = (words[w] < hw) | ((words[w] == hw) & le)
        hit = ge & le
        matched = hit if matched is None else (matched | hit)
    return matched


def glv_interval_mask(fmt: AddressFormat, x3, y3, lo, hi):
    """6-bit GLV variant mask per key: bit 2v+s set iff variant s*λ^v
    (s: 0=+, 1=-) of the key's point matches the intervals.

    The 6 points are {x, βx, β²x} × {±y}.  For compressed-hash160 formats
    the ± pair is exactly the two compressed-prefix parities, so y3 is never
    consulted (pass None); GLV_EXACT_Y formats (Ethereum, uncompressed
    p2pkh) hash full coordinates so y3 is required."""
    X, Y, PI = glv_variants(fmt, x3, y3)
    if fmt == AddressFormat.ETHEREUM:
        h = eth_account(X, Y)
    elif fmt == AddressFormat.P2PKH_UNCOMPRESSED:
        h = encode.hash160_65(uncompressed_pubkey_bytes(X, Y))
    else:
        h = encode.hash160_33(_compressed_bytes(X, PI))
        if fmt == AddressFormat.P2SH_P2WPKH:
            h = script_hash(h)
    words = bytes_be_words(h)
    return variant_bits(in_intervals(words, lo, hi))


def make_range_mask(fmt: AddressFormat, glv: bool = False):
    """Interval-matching mask stage: (x3, y3, valid, lo, hi, remaining,
    *extras) -> (matchbits (B,) int32, valid (B,) bool).  matchbits: 0 =
    miss; the 6-bit GLV variant mask on GLV paths, 1 otherwise."""

    def mask(x3, y3, valid, lo, hi, remaining, *extras):
        B = x3.shape[1]
        idx = jnp.arange(B, dtype=jnp.int32)
        valid = valid & (idx < remaining)
        if glv:
            assert fmt in GLV_FORMATS, fmt
            vmask = glv_interval_mask(fmt, x3, y3, lo, hi)
            return jnp.where(valid, vmask, 0), valid
        words, ok = interval_value_words(fmt, x3, y3, *extras)
        if ok is not None:
            valid = valid & ok
        matched = in_intervals(words, lo, hi) & valid
        return jnp.where(matched, jnp.int32(1), 0), valid

    return mask


def matcher_args(pattern, fmt: AddressFormat, ivs):
    """Host: the step's matcher arguments for a pattern -- (lo, hi) word
    bounds of the planned intervals, or (dfa_flat, dfa_accept, start) of
    the padded device DFA when ivs is None (see scan.route)."""
    if ivs is not None:
        lo, hi = intervals_to_words(
            ivs, INTERVAL_WORDS[fmt], n_slots=interval_slot_count(len(ivs))
        )
        return jnp.asarray(lo), jnp.asarray(hi)
    dev_dfa = pattern.device_dfa(fmt)
    flat, accept = pad_device_dfa(dev_dfa)
    return jnp.asarray(flat), jnp.asarray(accept), jnp.int32(dev_dfa.start)


def packed_scan_fn(fmt: AddressFormat, kind: str, glv: bool, chain_len: int,
                   k_sub: int, with_masks: bool = False):
    """k_sub-window packed scan step (un-jitted, so the mesh can shard_map
    it): scans k_sub consecutive key windows per dispatch and returns one
    packed (k_sub, PACKED_WIDTH) result, amortizing the host<->device
    round trip over k_sub windows.  with_masks: also return the (k_sub, B)
    int32 match masks (make_range_mask / make_format_mask layout), which
    stay on the device unless a window overflows its TOP_K slots.

    The k_sub windows run as ONE batch of k_sub*B keys (window k pairs its
    base point with the whole i*G table), so the sequential parts -- the
    inversion chains, the field inversion, the hash and DFA loops -- run
    once per dispatch over k_sub times the lanes instead of once per
    window.

    kind: "range" (margs = (lo, hi)) or "dfa" (margs = (dfa_flat,
    dfa_accept, start)).  Signature: step(bx (K,16), by (K,16), tx, ty,
    remaining (K,), *margs, *extras) -> (K, PACKED_WIDTH) int32
    [, (K, B) int32]."""
    mask = (
        make_range_mask(fmt, glv) if kind == "range"
        else make_format_mask(fmt, glv)
    )
    n_margs = 2 if kind == "range" else 3
    ops_mult = 6 if glv else 1

    def step(bx, by, tx, ty, remaining, *args):
        margs = args[:n_margs]
        extras = args[n_margs:]
        K, B = bx.shape[0], tx.shape[1]
        x3, y3, valid = curve.batch_affine_add(
            jnp.repeat(bx.T, B, axis=1), jnp.repeat(by.T, B, axis=1),
            jnp.tile(tx, (1, K)), jnp.tile(ty, (1, K)), chain_len=chain_len,
        )
        idx = jnp.arange(B, dtype=jnp.int32)
        valid = valid & (idx[None, :] < remaining[:, None]).reshape(K * B)
        bits, mvalid = mask(x3, y3, valid, *margs, jnp.int32(K * B), *extras)
        bits = bits.reshape(K, B)
        res = jax.vmap(lambda b, v: mask_to_result(b, v, ops_mult))(
            bits, mvalid.reshape(K, B)
        )
        packed = jnp.concatenate(
            [res.count[:, None], res.ops[:, None], res.indices, res.vbits],
            axis=1,
        )
        return (packed, bits) if with_masks else packed

    return step


@functools.lru_cache(maxsize=16)
def packed_xla_scan_step(fmt: AddressFormat, kind: str, glv: bool,
                         chain_len: int, k_sub: int):
    """Jitted packed_scan_fn with masks: the single-device scan step,
    -> ((K, PACKED_WIDTH) packed results, (K, B) match masks)."""
    return jax.jit(packed_scan_fn(fmt, kind, glv, chain_len, k_sub,
                                  with_masks=True))


def run_window(fmt: AddressFormat, kind: str, bx, by, tx, ty, remaining,
               margs, extras=(), chain_len: int = 256, glv: bool = False):
    """One key window (bx, by: (16,) base point limbs) through the packed
    step at k_sub=1 -> (StepResult of host values, (B,) int32 device mask).

    The mesh's overflow recovery: when a window matches more than TOP_K
    keys, the packed result's index slots truncate (the count does not),
    and the full match vector is fetched from this re-run -- a rare extra
    dispatch instead of silently dropping matches (the reference reports
    every match per batch, gpu.rs:1030-1093)."""
    step = packed_xla_scan_step(fmt, kind, glv, chain_len, 1)
    packed, masks = step(
        jnp.asarray(bx)[None], jnp.asarray(by)[None], tx, ty,
        jnp.full((1,), remaining, dtype=jnp.int32), *margs, *extras,
    )
    row = np.asarray(packed)[0]
    return StepResult(count=int(row[0]), indices=row[2:2 + TOP_K],
                      ops=int(row[1]), vbits=row[2 + TOP_K:]), masks[0]
