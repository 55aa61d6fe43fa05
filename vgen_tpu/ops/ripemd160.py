"""Batched RIPEMD-160, specialized to 32-byte inputs (SHA-256 digests).

Device counterpart of shaders/ripemd160.wgsl:1-100 (which is likewise
specialized to the hash160 use).  Structure: fori_loop over the 5 rounds,
16 unrolled steps per round, both parallel lines advanced together; the
per-round permutation/shift tables index the message words via one
(16,)-vector dynamic row lookup per round.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32

_PERM_L = np.array(
    [
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
        [7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8],
        [3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12],
        [1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2],
        [4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13],
    ],
    dtype=np.int32,
)
_PERM_R = np.array(
    [
        [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12],
        [6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2],
        [15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13],
        [8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14],
        [12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11],
    ],
    dtype=np.int32,
)
_SHIFT_L = np.array(
    [
        [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8],
        [7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12],
        [11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5],
        [11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12],
        [9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6],
    ],
    dtype=np.int32,
)
_SHIFT_R = np.array(
    [
        [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6],
        [9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11],
        [9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5],
        [15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8],
        [8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11],
    ],
    dtype=np.int32,
)
_K_L = np.array([0, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E], dtype=np.uint32)
_K_R = np.array([0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0], dtype=np.uint32)

_IV = np.array(
    [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0], dtype=np.uint32
)


def _rotl(x, n):
    # n is a traced uint32 scalar or a static int
    if isinstance(n, int):
        return (x << n) | (x >> (32 - n))
    n = n.astype(U32)
    return (x << n) | (x >> (jnp.uint32(32) - n))


def _f(j: int, x, y, z):
    if j == 0:
        return x ^ y ^ z
    if j == 1:
        return (x & y) | (~x & z)
    if j == 2:
        return (x | ~y) ^ z
    if j == 3:
        return (x & z) | (y & ~z)
    return x ^ (y | ~z)


def ripemd160_digest32(digest):
    """RIPEMD-160 of 32-byte messages: (32, *B) bytes -> (20, *B) bytes.

    Fixed single-block padding: x[8] = 0x80, x[14] = 256 bits."""
    B = digest.shape[1:]
    zero = jnp.zeros(B, dtype=U32)
    # little-endian 32-bit message words
    x = []
    for wi in range(8):
        word = zero
        for b in range(4):
            word = word | (digest[wi * 4 + b].astype(U32) << (8 * b))
        x.append(word)
    x.append(jnp.full(B, 0x80, dtype=U32))
    x += [zero] * 5
    x.append(jnp.full(B, 256, dtype=U32))
    x.append(zero)

    h = [jnp.full(B, int(v), dtype=U32) for v in _IV]

    # Fully static unroll: the per-round word permutations and shift amounts
    # become compile-time constants (the fori_loop formulation needed 32
    # serialized dynamic gathers per round -- a measured hotspot) and every
    # rotation is a pair of static shifts.  ~160 steps x ~12 ops traces fine.
    al, bl, cl, dl, el = h
    ar, br, cr, dr, er = h
    for rnd in range(5):
        kl = jnp.uint32(int(_K_L[rnd]))
        kr = jnp.uint32(int(_K_R[rnd]))
        for i in range(16):
            xl = x[int(_PERM_L[rnd][i])]
            xr = x[int(_PERM_R[rnd][i])]
            tl = _rotl(al + _f(rnd, bl, cl, dl) + xl + kl, int(_SHIFT_L[rnd][i])) + el
            tr = _rotl(ar + _f(4 - rnd, br, cr, dr) + xr + kr, int(_SHIFT_R[rnd][i])) + er
            al, bl, cl, dl, el = el, tl, bl, _rotl(cl, 10), dl
            ar, br, cr, dr, er = er, tr, br, _rotl(cr, 10), dr
    out = [
        h[1] + cl + dr,
        h[2] + dl + er,
        h[3] + el + ar,
        h[4] + al + br,
        h[0] + bl + cr,
    ]
    # little-endian byte serialization
    bts = []
    for w in out:
        for b in range(4):
            bts.append((w >> (8 * b)) & jnp.uint32(0xFF))
    return jnp.stack(bts)
