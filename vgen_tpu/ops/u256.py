"""256-bit unsigned integer arithmetic on 16-bit limbs in uint32 lanes.

Replacement for the reference's 8x u32-limb WGSL arithmetic
(shaders/field.wgsl:9-210).  The reference splits 32x32 multiplies into
16-bit halves by hand (field.wgsl:110-125, `mul32`); here limbs stay at 16
bits so every partial product fits a native uint32 multiply and
column sums stay below 2^22 -- no mulhi emulation, no per-element branches,
carry chains are short unrolled loops vectorized across the batch (lane)
dimension.

Representation: shape (L, *batch) uint32 arrays, little-endian limbs, each
limb < 2^16 at function boundaries ("normalized").
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

NLIMBS = 16  # 16 x 16-bit = 256 bits
LIMB_BITS = 16
LIMB_MASK = np.uint32(0xFFFF)

U32 = jnp.uint32


# ---------------------------------------------------------------------------
# Host <-> device conversion helpers (numpy; used in setup + tests only)
# ---------------------------------------------------------------------------

def from_int(value: Union[int, Sequence[int]], nlimbs: int = NLIMBS) -> np.ndarray:
    """Python int(s) -> (nlimbs,) or (nlimbs, B) uint32 limb array."""
    if isinstance(value, (int, np.integer)):
        v = int(value)
        return np.array(
            [(v >> (LIMB_BITS * i)) & 0xFFFF for i in range(nlimbs)], dtype=np.uint32
        )
    arr = np.zeros((nlimbs, len(value)), dtype=np.uint32)
    for b, v in enumerate(value):
        v = int(v)
        for i in range(nlimbs):
            arr[i, b] = (v >> (LIMB_BITS * i)) & 0xFFFF
    return arr


def to_int(limbs) -> Union[int, List[int]]:
    """(L,) -> int; (L, B) -> list of ints."""
    arr = np.asarray(limbs, dtype=np.uint64)
    if arr.ndim == 1:
        return sum(int(arr[i]) << (LIMB_BITS * i) for i in range(arr.shape[0]))
    out = []
    for b in range(arr.shape[1]):
        out.append(sum(int(arr[i, b]) << (LIMB_BITS * i) for i in range(arr.shape[0])))
    return out


# ---------------------------------------------------------------------------
# Core limb primitives (jnp, traced inside jit)
# ---------------------------------------------------------------------------

def constant(value: int, batch_shape: Tuple[int, ...] = (), nlimbs: int = NLIMBS):
    """Broadcast a Python int to a (nlimbs, *batch_shape) device constant.

    Built from scalar fills (not a materialized array literal); XLA
    constant-folds it."""
    rows = [
        jnp.full(batch_shape, (int(value) >> (LIMB_BITS * i)) & 0xFFFF, dtype=U32)
        for i in range(nlimbs)
    ]
    return jnp.stack(rows)


def u32_to_f32(x):
    """Exact uint32 -> float32 for values < 2^24 (bitcast through int32,
    whose f32 cast is exact in that range)."""
    return jax.lax.bitcast_convert_type(x, jnp.int32).astype(jnp.float32)


def f32_to_u32(x):
    """Exact float32 -> uint32 for non-negative values < 2^31."""
    return jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.uint32)


def carry_propagate(cols: List, n_out: int):
    """Propagate carries over per-column accumulators (< 2^32) producing
    n_out normalized 16-bit limbs.  Sequential over limbs, vector over batch.
    Drops any carry out of the top limb (callers must bound inputs)."""
    out = []
    carry = None
    for k in range(n_out):
        v = cols[k] if k < len(cols) else jnp.zeros_like(cols[0])
        if carry is not None:
            v = v + carry
        out.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    return jnp.stack(out), carry


def add(a, b):
    """(a + b) mod 2^256 -> (sum_limbs, carry_out)."""
    n = a.shape[0]
    cols = [a[i] + b[i] for i in range(n)]
    return carry_propagate(cols, n)


def add_small(a, k: int):
    """a + small-int k (k < 2^16)."""
    n = a.shape[0]
    cols = [a[i] + (jnp.uint32(k) if i == 0 else jnp.uint32(0)) for i in range(n)]
    return carry_propagate(cols, n)


def sub(a, b):
    """(a - b) mod 2^256 -> (diff_limbs, borrow_out (1 where a < b))."""
    n = a.shape[0]
    out = []
    borrow = jnp.zeros_like(a[0])
    for i in range(n):
        d = a[i] - b[i] - borrow
        out.append(d & LIMB_MASK)
        borrow = (d >> 31) & jnp.uint32(1)  # top bit set iff wrapped negative
    return jnp.stack(out), borrow


def geq(a, b):
    """a >= b elementwise over the batch -> bool array of batch shape."""
    _, borrow = sub(a, b)
    return borrow == 0


def is_zero(a):
    acc = a[0]
    for i in range(1, a.shape[0]):
        acc = acc | a[i]
    return acc == 0


def eq(a, b):
    acc = (a[0] ^ b[0])
    for i in range(1, a.shape[0]):
        acc = acc | (a[i] ^ b[i])
    return acc == 0


def select(mask, a, b):
    """Where mask (batch-shaped bool) pick a else b; limb-wise broadcast."""
    return jnp.where(mask[None, ...], a, b)


def _exact_f32_dots() -> bool:
    """Whether mul_cols may use its f32-dot form (scan.route decides per
    platform: exact f32 dots on the cpu only)."""
    from vgen_tpu.scan import route

    return route.exact_f32_dots(jax.default_backend())


def _antidiag_matrices(n: int):
    """0/1 selection matrices turning the flattened (n*n) outer product into
    2n anti-diagonal column sums via ONE matmul each.

    S0[k, i*n+j] = [i+j == k]; S1 shifts by one (the high halves).  f32 is
    exact here: entries are 16-bit halves (< 2^16) and each column sum has
    at most 2n terms, so sums stay < 2^21 << 2^24 mantissa.  As HLO it is 2
    dots instead of 2n^2 scalar-row adds, which keeps XLA:CPU compiles
    small.  Not exact under TF32 (scan.route.exact_f32_dots).

    Built from iotas (XLA constant-folds)."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (2 * n, n * n), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (2 * n, n * n), 1)
    ij = cols // n + cols % n
    S0 = (rows == ij).astype(jnp.float32)
    S1 = (rows == ij + 1).astype(jnp.float32)
    return S0, S1


def mul_cols(a, b):
    """Raw 256x256 schoolbook columns: (16,*B) x (16,*B) -> (32,*B)
    UNPROPAGATED column accumulators, each < 32*2^16 = 2^21.

    Callers either carry_propagate to a clean 512-bit product (mul_wide) or
    feed the columns straight into a fused mod-p fold (field._fold_cols),
    which skips one full 32-limb carry chain per multiply.
    """
    n = a.shape[0]
    assert n == NLIMBS
    batch_shape = a.shape[1:]
    if _exact_f32_dots():
        # CPU (and any true-f32 backend): one dot per half is exact
        p = a[:, None] * b[None, :]  # (n, n, *B)
        lo = p & LIMB_MASK
        hi = p >> LIMB_BITS
        S0, S1 = _antidiag_matrices(n)
        return f32_to_u32(
            jnp.dot(S0, u32_to_f32(lo).reshape(n * n, -1),
                    preferred_element_type=jnp.float32)
            + jnp.dot(S1, u32_to_f32(hi).reshape(n * n, -1),
                      preferred_element_type=jnp.float32)
        ).reshape((2 * n,) + batch_shape)
    # gpu: limb-row schoolbook, exact in u32 by construction.  Its f32 dots
    # run in TF32 (11-bit significand) and would round the 16-bit halves;
    # precision=HIGHEST would be exact but moves a (256, B) f32 plane per
    # multiply through memory.  Here: 16 iterations of whole-(16,*B)-array
    # multiply/mask/shift-add, accumulated into 32 columns via statically
    # shifted concatenations -- ~100 traced elementwise ops per multiply.
    batch = tuple(a.shape[1:])
    zrow = jnp.zeros((1,) + batch, dtype=jnp.uint32)

    def shifted(rows, k):
        """rows (m,*B) placed at column offset k within 2n columns."""
        m = rows.shape[0]
        parts = []
        if k:
            parts.append(jnp.broadcast_to(zrow, (k,) + batch))
        parts.append(rows)
        if 2 * n - m - k:
            parts.append(
                jnp.broadcast_to(zrow, (2 * n - m - k,) + batch)
            )
        return jnp.concatenate(parts, axis=0)

    acc = None
    for j in range(n):
        q = a * b[j][None]  # (n, *B): one vector multiply per source limb
        contrib = shifted(q & LIMB_MASK, j) + shifted(q >> LIMB_BITS, j + 1)
        acc = contrib if acc is None else acc + contrib
    # each column: <= 16 lo-halves + 16 hi-halves, all < 2^16 -> < 2^21
    return acc


def mul_wide(a, b):
    """Full 256x256 -> 512-bit product: (16,*B) x (16,*B) -> (32,*B).

    Schoolbook columns (mul_cols) plus one carry pass.  (The reference's
    device equivalent is fe_mul's 8x8 u32 schoolbook with hand-split mul32,
    shaders/field.wgsl:110-167 -- the 16-bit-limb choice makes every partial
    product a single native uint32 multiply with no mulhi emulation.)
    """
    acc = mul_cols(a, b)
    prod, _ = carry_propagate([acc[k] for k in range(2 * NLIMBS)], 2 * NLIMBS)
    return prod


def square_cols(a):
    """Raw squaring columns: (16,*B) -> (32,*B) UNPROPAGATED accumulators.

    Currently mul_cols(a, a): the symmetry trick halves multiplies but the
    accumulate adds dominate VPU op count, so it bought ~5% at a compile-size
    cost when measured -- revisit with tree accumulation."""
    return mul_cols(a, a)


def square_wide(a):
    """a*a -> (32,*B) full product."""
    acc = square_cols(a)
    prod, _ = carry_propagate([acc[k] for k in range(2 * NLIMBS)], 2 * NLIMBS)
    return prod


def mul_wide_unrolled(a, b):
    """Pad/add formulation of mul_wide (no matmul)."""
    n = a.shape[0]
    p = a[:, None] * b[None, :]
    lo = p & LIMB_MASK
    hi = p >> LIMB_BITS
    batch_pad = ((0, 0),) * (a.ndim - 1)
    acc = None
    for off, x in ((0, lo), (1, hi)):
        for i in range(n):
            r = jnp.pad(x[i], ((i + off, 2 * n - n - i - off),) + batch_pad)
            acc = r if acc is None else acc + r
    prod, _ = carry_propagate([acc[k] for k in range(2 * n)], 2 * n)
    return prod


def mul_small(a, k: int):
    """a * k for 0 <= k < 2^16 -> ((n+1),*B) limbs."""
    n = a.shape[0]
    ku = jnp.uint32(k)
    cols = [jnp.zeros_like(a[0])] * (n + 1)
    for i in range(n):
        p = a[i] * ku
        cols[i] = cols[i] + (p & LIMB_MASK)
        cols[i + 1] = cols[i + 1] + (p >> LIMB_BITS)
    prod, _ = carry_propagate(cols, n + 1)
    return prod


def shift_limbs_up(a, k: int, n_out: int):
    """a * 2^(16k), widened/truncated to n_out limbs."""
    zero = jnp.zeros_like(a[0])
    parts = [zero] * k + [a[i] for i in range(a.shape[0])]
    parts = parts[:n_out] + [zero] * max(0, n_out - len(parts))
    return jnp.stack(parts[:n_out])


def get_byte_be(a, byte_index: int):
    """Big-endian byte #byte_index (0 = most significant) of a 256-bit value."""
    bit_from_lsb = (31 - byte_index) * 8
    limb = bit_from_lsb // LIMB_BITS
    shift = bit_from_lsb % LIMB_BITS
    return (a[limb] >> shift) & jnp.uint32(0xFF)


def to_bytes_be(a, n_bytes: int = 32):
    """(16,*B) -> (n_bytes,*B) big-endian bytes (each a uint32 in [0,255])."""
    return jnp.stack([get_byte_be(a, i) for i in range(n_bytes)])


def from_bytes_be(b):
    """(32,*B) big-endian bytes -> (16,*B) limbs."""
    n_bytes = b.shape[0]
    assert n_bytes % 2 == 0
    limbs = []
    for i in range(n_bytes // 2):
        hi = b[n_bytes - 2 - 2 * i]
        lo = b[n_bytes - 1 - 2 * i]
        limbs.append((hi << 8) | lo)
    return jnp.stack(limbs)
