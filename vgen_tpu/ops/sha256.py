"""Batched SHA-256 (uint32 lanes over the batch dimension).

Device counterpart of the reference's single-block-specialized WGSL SHA-256
(shaders/sha256.wgsl:1-170) plus the TapTweak midstate variant the reference
defined but never ran on-device (sha256.wgsl:177-249).  Message schedules for
our fixed-size inputs (33-byte pubkey, 25-byte address payload, 32-byte
digests) are built with constant padding baked in.

Structure: rounds 0-15 traced statically, then a fori_loop over three
16-round blocks (see compress).
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32

_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
).reshape(4, 16)

IV = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)


def _rotr(x, n: int):
    return (x >> n) | (x << (32 - n))


def compress(state, w):
    """One SHA-256 compression: state (8,*B) or list, w list of 16 (*B,)
    word rows or Python-int constant words.

    Rounds 0-15 are traced statically, then a fori_loop runs three 16-round
    blocks, each first advancing the 16-word schedule in place.  Sixteen
    rounds per iteration bring every state and schedule word back to its
    own slot, so the loop carry is recomputed whole and never shuffled (a
    one-round body rotates the carry, and on the gpu those copies were most
    of the step).  A fully unrolled 64-round reconvergent DAG makes some
    XLA:CPU builds evaluate it as an expression TREE (minutes per batch); a
    16-round body stays under that cliff.
    Returns the new (8, *B) state (IV-added)."""
    kvec = jnp.asarray(_K.reshape(-1))
    st0 = jnp.stack([state[i] for i in range(8)])
    w = tuple(
        jnp.full(st0.shape[1:], w[i], dtype=U32) if isinstance(w[i], int)
        else w[i]
        for i in range(16)
    )

    def rounds16(st, ws, ks):
        a, b, c, d, e, f, g, h = st
        for i in range(16):
            S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            t1 = h + S1 + ch + ks[i] + ws[i]
            S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            a, b, c, d, e, f, g, h = t1 + S0 + maj, a, b, c, d + t1, e, f, g
        return (a, b, c, d, e, f, g, h)

    def next_schedule(ws):
        # w[t] = w[t-16] + s0(w[t-15]) + w[t-7] + s1(w[t-2]), in place over
        # the 16 slots (slot i holds w[t] for t = i mod 16)
        ws = list(ws)
        for i in range(16):
            x1, x14 = ws[(i + 1) % 16], ws[(i + 14) % 16]
            s0 = _rotr(x1, 7) ^ _rotr(x1, 18) ^ (x1 >> 3)
            s1 = _rotr(x14, 17) ^ _rotr(x14, 19) ^ (x14 >> 10)
            ws[i] = ws[i] + s0 + ws[(i + 9) % 16] + s1
        return tuple(ws)

    def block(j, carry):
        st, ws = carry
        ws = next_schedule(ws)
        ks = jax.lax.dynamic_slice(kvec, (16 * j,), (16,))
        return rounds16(st, ws, [ks[i] for i in range(16)]), ws

    st = rounds16(tuple(st0[i] for i in range(8)), w,
                  [kvec[i] for i in range(16)])
    st, _ = jax.lax.fori_loop(1, 4, block, (st, w))
    return jnp.stack(st) + st0


def initial_state(batch_shape):
    return jnp.stack(
        [jnp.full(tuple(batch_shape), int(v), dtype=U32) for v in IV]
    )


def _push_byte(word, byte):
    """(word << 8) | byte for u32 rows or Python-int constants; int operands
    fold at trace time, so constant padding bytes cost nothing."""
    word = ((word << 8) & 0xFFFFFFFF) if isinstance(word, int) else word << 8
    if isinstance(word, int) and isinstance(byte, int):
        return word | byte
    if isinstance(word, int):
        word, byte = byte, word
    if isinstance(byte, int):
        return word | np.uint32(byte) if byte else word
    return word | byte


def words_from_bytes(data, msg_len: int):
    """Build the 16-word single-block schedule for a message of msg_len bytes
    (<= 55) given data as a (msg_len, *B) byte array.  Words holding only
    padding/length bytes come out as Python-int constants (compress
    broadcasts them)."""
    assert msg_len <= 55
    w = []
    for wi in range(16):
        word = 0
        for b in range(4):
            idx = wi * 4 + b
            if idx < msg_len:
                byte = data[idx]
            elif idx == msg_len:
                byte = 0x80
            elif wi == 15 and idx >= 62:
                byte = ((msg_len * 8) >> (8 * (63 - idx))) & 0xFF
            else:
                byte = 0
            word = _push_byte(word, byte)
        w.append(word)
    return w


def sha256_bytes(data, msg_len: int):
    """SHA-256 of fixed-length (<= 55 byte) messages: (L,*B) bytes -> (32,*B)."""
    B = data.shape[1:]
    st = compress(initial_state(B), words_from_bytes(data, msg_len))
    return state_to_bytes(st)


def sha256_bytes_2block(data, msg_len: int):
    """SHA-256 for 56 <= msg_len <= 119 byte messages (two blocks).

    Needed for the 65-byte uncompressed pubkey (P2PKH-uncompressed path,
    which the reference only ever hashed on CPU via the bitcoin crate)."""
    assert 56 <= msg_len <= 119
    B = data.shape[1:]
    zero = jnp.zeros(B, dtype=U32)
    # block 1: bytes 0..63 straight from the message
    w1 = []
    for wi in range(16):
        word = zero
        for b in range(4):
            idx = wi * 4 + b
            byte = data[idx] if idx < min(msg_len, 64) else (
                jnp.full(B, 0x80, dtype=U32) if idx == msg_len else zero
            )
            word = (word << 8) | byte
        w1.append(word)
    st = compress(initial_state(B), w1)
    # block 2: remaining bytes + pad + length
    w2 = []
    bits = msg_len * 8
    for wi in range(16):
        word = zero
        for b in range(4):
            idx = 64 + wi * 4 + b
            if idx < msg_len:
                byte = data[idx]
            elif idx == msg_len:
                byte = jnp.full(B, 0x80, dtype=U32)
            elif idx >= 126:
                byte = jnp.full(B, (bits >> (8 * (127 - idx))) & 0xFF, dtype=U32)
            else:
                byte = zero
            word = (word << 8) | byte
        w2.append(word)
    return state_to_bytes(compress(st, w2))


def state_to_bytes(state):
    """(8, *B) state words -> (32, *B) big-endian digest bytes."""
    out = []
    for i in range(8):
        for shift in (24, 16, 8, 0):
            out.append((state[i] >> shift) & jnp.uint32(0xFF))
    return jnp.stack(out)


def double_sha256_bytes(data, msg_len: int):
    """SHA256(SHA256(msg)) for msg_len <= 55 (checksum path)."""
    return sha256_bytes(sha256_bytes(data, msg_len), 32)


def tagged_midstate(tag: str) -> np.ndarray:
    """Host: midstate after compressing SHA256(tag)||SHA256(tag) (= 1 block).

    BIP340 tagged hash with the first block precomputed -- finishing the job
    the reference's dead code started (sha256.wgsl:177-184)."""
    import hashlib

    t = hashlib.sha256(tag.encode()).digest()
    block = t + t
    # run one compression on the host
    w = [int.from_bytes(block[4 * i : 4 * i + 4], "big") for i in range(16)]
    state = [int(x) for x in IV]
    k = [int(x) for x in _K.reshape(-1)]
    M = 0xFFFFFFFF

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & M

    a, b, c, d, e, f, g, h = state
    ws = list(w)
    for i in range(64):
        if i >= 16:
            s0 = rotr(ws[(i - 15) % 16], 7) ^ rotr(ws[(i - 15) % 16], 18) ^ (
                ws[(i - 15) % 16] >> 3
            )
            s1 = rotr(ws[(i - 2) % 16], 17) ^ rotr(ws[(i - 2) % 16], 19) ^ (
                ws[(i - 2) % 16] >> 10
            )
            ws[i % 16] = (ws[i % 16] + s0 + ws[(i - 7) % 16] + s1) & M
        wi = ws[i % 16]
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g) & M
        t1 = (h + s1 + ch + k[i] + wi) & M
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & M
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M, c, b, a, (t1 + t2) & M
    return np.array(
        [(x + y) & M for x, y in zip([a, b, c, d, e, f, g, h], state)],
        dtype=np.uint32,
    )


def tagged_hash_32(midstate: np.ndarray, data32):
    """SHA256 tagged hash of a 32-byte payload given the tag midstate.

    Message is tag32||tag32||data32 = 96 bytes; block 2 = data32 + padding."""
    B = data32.shape[1:]
    zero = jnp.zeros(B, dtype=U32)
    w = []
    for wi in range(8):
        word = zero
        for b in range(4):
            word = (word << 8) | data32[wi * 4 + b]
        w.append(word)
    w.append(jnp.full(B, 0x80000000, dtype=U32))  # w[8]
    for _ in range(6):
        w.append(zero)
    w.append(jnp.full(B, 96 * 8, dtype=U32))  # w[15] = bit length 768
    st = jnp.stack(
        [jnp.full(tuple(B), int(v), dtype=U32) for v in np.asarray(midstate)]
    )
    return state_to_bytes(compress(st, w))
