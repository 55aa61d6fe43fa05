"""Batched Keccak-256 with 64-bit lanes emulated as uint32 pairs.

The reference never ran Keccak on-device (Ethereum was CPU-only,
lib.rs:316-319); here both the address hash (64-byte pubkey coordinates)
and the EIP-55 checksum hash (40 ASCII hex chars) run on the device.  Both inputs
fit a single 136-byte-rate block, so absorption is constant-shaped.

State: two (25, *B) uint32 arrays (hi, lo), lane index x + 5*y.  Rotations
are static per lane, so the round body unrolls with shifts only.  The 24
rounds run under fori_loop (24x less graph to compile).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32

_RC = np.array(
    [
        0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
        0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
        0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
        0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
        0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
        0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
        0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
        0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
    ],
    dtype=np.uint64,
)
_RC_HI = (_RC >> 32).astype(np.uint32)
_RC_LO = (_RC & 0xFFFFFFFF).astype(np.uint32)

# rotation offset for lane (x, y) at index x + 5*y
_ROT = np.zeros(25, dtype=np.int32)
_rot_xy = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
for _x in range(5):
    for _y in range(5):
        _ROT[_x + 5 * _y] = _rot_xy[_x][_y]


def _rotl64(hi, lo, n: int):
    n %= 64
    if n == 0:
        return hi, lo
    if n == 32:
        return lo, hi
    if n < 32:
        nh = (hi << n) | (lo >> (32 - n))
        nl = (lo << n) | (hi >> (32 - n))
        return nh, nl
    m = n - 32
    nh = (lo << m) | (hi >> (32 - m))
    nl = (hi << m) | (lo >> (32 - m))
    return nh, nl


def keccak_f1600(hi, lo):
    """Permutation on (25, *B) hi/lo uint32 arrays: 24 rounds under
    fori_loop with the round constants indexed per iteration."""
    rc_hi = jnp.asarray(_RC_HI)
    rc_lo = jnp.asarray(_RC_LO)

    def round_body(r, carry):
        hi, lo = carry
        # theta
        chi = [hi[x] ^ hi[x + 5] ^ hi[x + 10] ^ hi[x + 15] ^ hi[x + 20] for x in range(5)]
        clo = [lo[x] ^ lo[x + 5] ^ lo[x + 10] ^ lo[x + 15] ^ lo[x + 20] for x in range(5)]
        dhi, dlo = [], []
        for x in range(5):
            rh, rl = _rotl64(chi[(x + 1) % 5], clo[(x + 1) % 5], 1)
            dhi.append(chi[(x - 1) % 5] ^ rh)
            dlo.append(clo[(x - 1) % 5] ^ rl)
        ahi = [hi[x + 5 * y] ^ dhi[x] for y in range(5) for x in range(5)]
        alo = [lo[x + 5 * y] ^ dlo[x] for y in range(5) for x in range(5)]
        # rho + pi
        bhi = [None] * 25
        blo = [None] * 25
        for x in range(5):
            for y in range(5):
                src = x + 5 * y
                dst = y + 5 * ((2 * x + 3 * y) % 5)
                bhi[dst], blo[dst] = _rotl64(ahi[src], alo[src], int(_ROT[src]))
        # chi
        nhi = []
        nlo = []
        for y in range(5):
            for x in range(5):
                i0, i1, i2 = x + 5 * y, (x + 1) % 5 + 5 * y, (x + 2) % 5 + 5 * y
                nhi.append(bhi[i0] ^ (~bhi[i1] & bhi[i2]))
                nlo.append(blo[i0] ^ (~blo[i1] & blo[i2]))
        # iota
        nhi[0] = nhi[0] ^ rc_hi[r]
        nlo[0] = nlo[0] ^ rc_lo[r]
        return jnp.stack(nhi), jnp.stack(nlo)

    return jax.lax.fori_loop(0, 24, round_body, (hi, lo))


def keccak256_bytes(data, msg_len: int):
    """Keccak-256 of fixed-length messages (<= 135 bytes, single block).

    data: (msg_len, *B) byte values -> (32, *B) digest bytes."""
    assert msg_len <= 135
    B = data.shape[1:]
    zero = jnp.zeros(B, dtype=U32)
    # build 17 lanes (136 bytes) little-endian with pad 0x01 .. 0x80
    hi = []
    lo = []
    for lane in range(25):
        h = zero
        l = zero
        if lane < 17:
            for b in range(8):
                idx = lane * 8 + b
                if idx < msg_len:
                    byte = data[idx].astype(U32)
                elif idx == msg_len:
                    byte = jnp.full(B, 0x01, dtype=U32)
                else:
                    byte = zero
                if idx == 135:
                    byte = byte | 0x80
                if b < 4:
                    l = l | (byte << (8 * b))
                else:
                    h = h | (byte << (8 * (b - 4)))
        hi.append(h)
        lo.append(l)
    hi, lo = keccak_f1600(jnp.stack(hi), jnp.stack(lo))
    out = []
    for lane in range(4):
        for b in range(8):
            if b < 4:
                out.append((lo[lane] >> (8 * b)) & jnp.uint32(0xFF))
            else:
                out.append((hi[lane] >> (8 * (b - 4))) & jnp.uint32(0xFF))
    return jnp.stack(out)
