"""On-device address encoders: Base58Check, Bech32/Bech32m, hex + EIP-55.

The reference encodes addresses on the HOST for every candidate -- 512K
Base58/Bech32 string builds + regex runs per GPU batch on a rayon pool
(gpu.rs:1030-1093).  Moving the encoders onto the device is the structural
win of this design (SURVEY.md §7): the device emits *digit symbols* in each
format's alphabet, the DFA matches them directly, and no ASCII ever
materializes on the host except for the winners.

Each encoder returns (symbols, length):
  symbols: (T, *B) int32 digit indices into the format's digit alphabet
           (see pattern.pattern._DEVICE_ALPHABETS)
  length:  (*B,) int32 actual symbol count (address length minus any
           constant prefix); positions >= length are unspecified -- the
           matcher overlays EOS/PAD.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from vgen_tpu.ops import keccak as dev_keccak
from vgen_tpu.ops import ripemd160 as dev_ripemd
from vgen_tpu.ops import sha256 as dev_sha

U32 = jnp.uint32

# division by 58 via multiply-by-reciprocal: exact for cur < 58*256 (verified
# exhaustively in tests) -- the VPU has no integer divide (SURVEY.md §7
# "hard parts (c)")
_DIV58_MUL = 4520
_DIV58_SHIFT = 18


def _divmod58(cur):
    q = (cur * jnp.uint32(_DIV58_MUL)) >> _DIV58_SHIFT
    return q, cur - q * jnp.uint32(58)


def _div58_f32(v):
    """v // 58 for v < 2^22, via f32 reciprocal + +-1 correction (exact;
    verified exhaustively in tests)."""
    from vgen_tpu.ops.u256 import f32_to_u32, u32_to_f32

    vf = u32_to_f32(v)
    q = f32_to_u32(jnp.floor(vf * jnp.float32(1.0 / 58.0)))
    # correct possible +-1 from f32 rounding (q*58 <= ~2^22, no u32 wrap)
    q = jnp.where(q * jnp.uint32(58) > v, q - 1, q)
    q = jnp.where(v - q * jnp.uint32(58) >= jnp.uint32(58), q + 1, q)
    return q


# 256^i (i < 25) expressed as 34 base-58 digits, LSD first: turns base
# conversion into ONE exact f32 matmul + a single carry sweep.
def _pow256_base58_matrix() -> np.ndarray:
    # column i multiplies payload byte i, which is big-endian: power 24-i
    mat = np.zeros((34, 25), dtype=np.float32)
    for i in range(25):
        v = 1 << (8 * (24 - i))
        for k in range(34):
            v, r = divmod(v, 58)
            mat[k, i] = r
    return mat


_POW256_B58 = _pow256_base58_matrix()


def base58check_symbols(payload21, basis=None):
    """Base58Check of version||hash160: (21, *B) bytes -> (symbols(34), length).

    Appends the 4-byte double-SHA checksum on device, converts the 25-byte
    number to base 58 via a digit-basis matmul (sum_i bytes[i] * base58(256^i),
    exact in f32: entries < 58*256, 25-term sums < 2^19) followed by ONE
    LSD->MSD carry sweep -- replacing 34x25 sequential divmod steps with one
    matmul.  Then shifts by
    (leading-zero-digits - leading-zero-bytes) so the emitted symbol string
    equals the canonical minimal encoding ('1' per leading zero byte).
    """
    check = dev_sha.double_sha256_bytes(payload21, 21)[:4]
    payload = jnp.concatenate([payload21, check], axis=0)  # (25, *B)
    return _base58_from_payload25(payload, basis)


def _base58_from_payload25(payload, basis=None):
    B = payload.shape[1:]
    # Precision DEFAULT is TF32 on the gpu (11-bit significand, exact for
    # integers below 2^11) and exact here: basis entries are < 58, payload
    # bytes < 256, and the f32 accumulation stays below 2^19 < 2^24.
    from vgen_tpu.ops.u256 import f32_to_u32, u32_to_f32

    if basis is None:
        basis = jnp.asarray(_POW256_B58)  # (34, 25)
    payload_f = u32_to_f32(payload)
    if payload_f.ndim == 3:
        # (V, T) 2D batches: contract the byte dim directly
        acc = f32_to_u32(
            jax.lax.dot_general(
                basis, payload_f,
                dimension_numbers=(((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.DEFAULT,
                preferred_element_type=jnp.float32,
            )
        )  # (34, V, T)
    else:
        payload_2d = payload_f.reshape(25, -1)
        acc = f32_to_u32(
            jax.lax.dot(
                basis, payload_2d,
                precision=jax.lax.Precision.DEFAULT,
                preferred_element_type=jnp.float32,
            )
        ).reshape((34,) + tuple(B))  # entries < 25*57*255 < 2^19

    # one forward carry sweep in base 58 (carry < 2^19/58 + ... < 2^14)
    digits_lsd = []
    carry = jnp.zeros(B, dtype=U32)
    for k in range(34):
        v = acc[k] + carry
        q = _div58_f32(v)
        digits_lsd.append(v - q * jnp.uint32(58))
        carry = q
    # carry out of digit 33 is provably 0 for 25-byte values with version 0/5
    digits = jnp.stack(digits_lsd[::-1])  # (34, *B) MSD first

    # leading zero bytes of payload / zero digits (unrolled prefix-product)
    def _leading_zeros(rows):
        prefix = jnp.ones(rows.shape[1:], dtype=jnp.int32)
        count = jnp.zeros(rows.shape[1:], dtype=jnp.int32)
        for r in range(rows.shape[0]):
            prefix = prefix * jnp.where(rows[r] == 0, 1, 0)
            count = count + prefix
        return count

    z = _leading_zeros(payload)
    k = _leading_zeros(digits)
    shift = k - z  # int32, in [0, 21] (see tests)
    length = jnp.int32(34) - shift

    # branchless data-dependent shift: select among the 22 possible static
    # shifts (gather-free)
    digits_i = jax.lax.bitcast_convert_type(digits, jnp.int32)
    pad_rows = jnp.zeros((21,) + tuple(B), dtype=jnp.int32)
    ext = jnp.concatenate([digits_i, pad_rows], axis=0)  # (55, *B)
    syms = ext[:34]
    for v in range(1, 22):
        syms = jnp.where(shift[None] == v, ext[v : v + 34], syms)
    return syms, length


# --- bech32 ----------------------------------------------------------------

_BECH32_GEN = (0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3)


def _polymod_init(hrp: str, witver: int) -> int:
    """Host: polymod state after the constant prefix (hrp expansion + witver)."""
    chk = 1
    values = [ord(c) >> 5 for c in hrp] + [0] + [ord(c) & 31 for c in hrp] + [witver]
    for v in values:
        top = chk >> 25
        chk = (chk & 0x1FFFFFF) << 5 ^ v
        for i in range(5):
            if (top >> i) & 1:
                chk ^= _BECH32_GEN[i]
    return chk


def _polymod_step(chk, v):
    top = chk >> 25
    chk = ((chk & jnp.uint32(0x1FFFFFF)) << 5) ^ v
    for i in range(5):
        bit = (top >> i) & jnp.uint32(1)
        chk = chk ^ (bit * jnp.uint32(_BECH32_GEN[i]))
    return chk


def segwit_symbols(program_bytes, witver: int, hrp: str = "bc"):
    """Bech32/Bech32m data symbols after the constant "bc1" prefix.

    program_bytes: (20,*B) for v0 / (32,*B) for v1.
    Returns (symbols, length): [witver digit] + base32 groups + 6 checksum
    digits; length is constant (39 for P2WPKH, 59 for P2TR)."""
    n_bytes = program_bytes.shape[0]
    B = program_bytes.shape[1:]
    n_groups = (n_bytes * 8 + 4) // 5
    # regroup 8-bit -> 5-bit, left-aligned zero padding (BIP173 convertbits)
    groups = []
    for g in range(n_groups):
        bit0 = 5 * g  # MSB-first bit offset
        byte0 = bit0 // 8
        sh = bit0 % 8
        hi = program_bytes[byte0].astype(U32)
        lo = (
            program_bytes[byte0 + 1].astype(U32)
            if byte0 + 1 < n_bytes
            else jnp.zeros(B, dtype=U32)
        )
        val = ((hi << 8) | lo) >> (11 - sh)
        groups.append(val & jnp.uint32(31))

    const = 1 if witver == 0 else 0x2BC830A3
    chk = jnp.full(B, _polymod_init(hrp, witver), dtype=U32)
    for gval in groups:
        chk = _polymod_step(chk, gval)
    for _ in range(6):
        chk = _polymod_step(chk, jnp.zeros(B, dtype=U32))
    chk = chk ^ jnp.uint32(const)
    checksum = [(chk >> (5 * (5 - i))) & jnp.uint32(31) for i in range(6)]

    witsym = jnp.full(B, witver, dtype=U32)
    syms = jax.lax.bitcast_convert_type(
        jnp.stack([witsym] + groups + checksum), jnp.int32
    )
    length = jnp.full(B, 1 + n_groups + 6, dtype=jnp.int32)
    return syms, length


# --- ethereum hex + EIP-55 -------------------------------------------------

# ASCII codes of lowercase hex digits, for feeding the checksum keccak


def eth_symbols(addr20):
    """EIP-55 checksummed hex symbols for a 20-byte account.

    addr20: (20,*B) -> (symbols(40), length=40).  Symbols: 0-9 -> 0..9,
    a-f -> 10..15, A-F -> 16..21 (the cased-hex device alphabet)."""
    B = addr20.shape[1:]
    nibbles = []
    for i in range(20):
        nibbles.append((addr20[i] >> 4) & jnp.uint32(0xF))
        nibbles.append(addr20[i] & jnp.uint32(0xF))
    nib = jnp.stack(nibbles)  # (40, *B) values 0..15

    # gather-free lowercase-hex ASCII ('0'=48, 'a'-10=87)
    ascii_lower = nib + jnp.uint32(48) + jnp.where(
        nib >= 10, jnp.uint32(39), jnp.uint32(0)
    )
    digest = dev_keccak.keccak256_bytes(ascii_lower, 40)
    # checksum nibble per position
    csn = []
    for i in range(20):
        csn.append((digest[i] >> 4) & jnp.uint32(0xF))
        csn.append(digest[i] & jnp.uint32(0xF))
    cs = jnp.stack(csn)  # (40, *B)

    is_alpha = nib >= 10
    upper = is_alpha & (cs >= 8)
    syms = jnp.where(upper, nib + 6, nib).astype(jnp.int32)
    length = jnp.full(B, 40, dtype=jnp.int32)
    return syms, length


# --- hash160 convenience ---------------------------------------------------

def hash160_33(pubkey33):
    return dev_ripemd.ripemd160_digest32(dev_sha.sha256_bytes(pubkey33, 33))


def hash160_22(script22):
    return dev_ripemd.ripemd160_digest32(dev_sha.sha256_bytes(script22, 22))


def hash160_65(pubkey65):
    return dev_ripemd.ripemd160_digest32(
        dev_sha.sha256_bytes_2block(pubkey65, 65)
    )
