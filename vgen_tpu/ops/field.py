"""secp256k1 base field F_p arithmetic, batched on the device.

p = 2^256 - 2^32 - 977, so 2^256 === 2^32 + 977 (mod p): reduction is two
cheap folds plus one conditional subtract -- the same identity the reference
exploits in its `fold_single` (shaders/field.wgsl:18-38) re-expressed over
16-bit limbs with an extra headroom limb so no intermediate ever branches.

All values: (16, *batch) uint32 limb arrays, normalized, < p at boundaries.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from vgen_tpu.crypto.secp256k1 import N as _N_INT
from vgen_tpu.crypto.secp256k1 import P as _P_INT
from vgen_tpu.ops import u256
from vgen_tpu.ops.u256 import LIMB_BITS, LIMB_MASK, NLIMBS

P_INT = _P_INT
N_INT = _N_INT
_C = 977  # 2^256 mod p = 2^32 + 977


def _p_limbs(like):
    return u256.constant(P_INT, like.shape[1:])


def normalize_weak_to_canonical(a):
    """Reduce a value < 2p to [0, p) with one conditional subtract."""
    d, borrow = u256.sub(a, _p_limbs(a))
    return u256.select(borrow == 0, d, a)


def add(a, b):
    s, carry = u256.add(a, b)
    # s_true = s + carry*2^256 === s + carry*(2^32+977)
    cols = [s[i] for i in range(NLIMBS)]
    cols[0] = cols[0] + carry * jnp.uint32(_C)
    cols[2] = cols[2] + carry
    s2, carry2 = u256.carry_propagate(cols, NLIMBS)
    # carry2 can only be nonzero if s was within 2^33 of 2^256; fold again
    cols = [s2[i] for i in range(NLIMBS)]
    cols[0] = cols[0] + carry2 * jnp.uint32(_C)
    cols[2] = cols[2] + carry2
    s3, _ = u256.carry_propagate(cols, NLIMBS)
    return normalize_weak_to_canonical(s3)


def sub(a, b):
    d, borrow = u256.sub(a, b)
    # if a < b: d wrapped mod 2^256; add p back (mod 2^256: subtract 2^32+977)
    corr, _ = u256.sub(d, u256.constant(1 << 32, d.shape[1:]))
    corr, _ = u256.sub(corr, u256.constant(_C, d.shape[1:]))
    return u256.select(borrow == 0, d, corr)


def neg(a):
    """-a mod p (a must be canonical; returns canonical, with -0 = 0)."""
    d, _ = u256.sub(_p_limbs(a), a)
    return u256.select(u256.is_zero(a), a, d)


def _fold512(prod):
    """(32,*B) 512-bit -> (16,*B) canonical mod-p value."""
    lo = prod[:NLIMBS]
    hi = prod[NLIMBS:]
    # r1 = lo + hi*(2^32 + 977); hi*977 needs 17 limbs, plus 2-limb shift
    cols = [lo[i] for i in range(NLIMBS)] + [jnp.zeros_like(lo[0])] * 3
    for i in range(NLIMBS):
        p977 = hi[i] * jnp.uint32(_C)
        cols[i] = cols[i] + (p977 & LIMB_MASK)
        cols[i + 1] = cols[i + 1] + (p977 >> LIMB_BITS)
        cols[i + 2] = cols[i + 2] + hi[i]
    r1, _ = u256.carry_propagate(cols, NLIMBS + 3)  # < 2^289
    lo1, hi1 = r1[:NLIMBS], r1[NLIMBS:]  # hi1: 3 limbs, < 2^33
    cols = [lo1[i] for i in range(NLIMBS)] + [jnp.zeros_like(lo1[0])]
    for i in range(3):
        p977 = hi1[i] * jnp.uint32(_C)
        cols[i] = cols[i] + (p977 & LIMB_MASK)
        cols[i + 1] = cols[i + 1] + (p977 >> LIMB_BITS)
        cols[i + 2] = cols[i + 2] + hi1[i]
    r2, _ = u256.carry_propagate(cols, NLIMBS + 1)  # < 2^256 + 2^66
    lo2, hi2 = r2[:NLIMBS], r2[NLIMBS]  # hi2 scalar limb, 0 or 1
    cols = [lo2[i] for i in range(NLIMBS)]
    cols[0] = cols[0] + hi2 * jnp.uint32(_C)
    cols[2] = cols[2] + hi2
    r3, carry3 = u256.carry_propagate(cols, NLIMBS)
    # carry3 == 0 always: lo2 < 2^256 and the fold adds < 2^34... except when
    # lo2 is within 2^34 of 2^256; one more fold for full safety:
    cols = [r3[i] for i in range(NLIMBS)]
    cols[0] = cols[0] + carry3 * jnp.uint32(_C)
    cols[2] = cols[2] + carry3
    r4, _ = u256.carry_propagate(cols, NLIMBS)
    return normalize_weak_to_canonical(r4)


def _fold_cols(cols):
    """Fused mod-p fold of RAW schoolbook column accumulators.

    cols: (32, *B) unpropagated columns, each < 2^22 (mul_cols/square_cols
    bound).  Folds hi*(2^32 + 977) into the low columns BEFORE any carry
    pass, so one 19-limb chain replaces _fold512's separate 32-limb product
    chain + 19-limb fold chain.  Column bound check: 977*2^22 + 2*2^22 =
    4.11e9 < 2^32.  Returns a WEAK value in [0, 2^256) (== mod p, possibly
    >= p); callers needing canonical apply normalize_weak_to_canonical.

    Chain steps: 19 + 17 + 16 + 3 = 55 vs _fold512-after-mul_wide's
    32 + 19 + 17 + 16 + 16 = 100.
    """
    n = NLIMBS
    c977 = jnp.uint32(_C)
    # fold 1: value = lo_cols + hi_cols*(2^32 + 977) < 2^295 -> 19 limbs
    c1 = []
    for i in range(n):
        v = cols[i] + cols[n + i] * c977
        if i >= 2:
            v = v + cols[n - 2 + i]
        c1.append(v)
    c1.append(cols[30])
    c1.append(cols[31])
    c1.append(jnp.zeros_like(cols[0]))
    r1, _ = u256.carry_propagate(c1, n + 3)
    # fold 2: hi1 = r1[16:19] < 2^39; value < 2^256 + 2^72 -> 17 limbs
    c2 = [r1[i] for i in range(n)] + [jnp.zeros_like(r1[0])]
    for j in range(3):
        c2[j] = c2[j] + r1[n + j] * c977
        c2[j + 2] = c2[j + 2] + r1[n + j]
    r2, _ = u256.carry_propagate(c2, n + 1)
    # fold 3: hi2 = r2[16] in {0,1}
    hi2 = r2[n]
    c3 = [r2[i] for i in range(n)]
    c3[0] = c3[0] + hi2 * c977
    c3[2] = c3[2] + hi2
    r3, carry3 = u256.carry_propagate(c3, n)
    # fold 4: carry3 in {0,1}, and nonzero only when r3 < 2^34 -- the carry
    # chain dies within 3 limbs, so a short tail replaces a full pass
    t0 = r3[0] + carry3 * c977
    t1 = r3[1] + (t0 >> LIMB_BITS)
    t2 = r3[2] + carry3 + (t1 >> LIMB_BITS)
    # t2 < 2^16 in both carry3 cases (r3[2] <= 3 when carry3 == 1), so no
    # carry escapes limb 2
    return jnp.concatenate(
        [(t0 & LIMB_MASK)[None], (t1 & LIMB_MASK)[None], t2[None], r3[3:]],
        axis=0,
    )


def mul_weak(a, b):
    """a*b mod p, WEAK output in [0, 2^256).  Inputs may be weak too."""
    return _fold_cols(u256.mul_cols(a, b))


def square_weak(a):
    return _fold_cols(u256.square_cols(a))


def mul(a, b):
    return normalize_weak_to_canonical(mul_weak(a, b))


def square(a):
    return normalize_weak_to_canonical(square_weak(a))


def mul_small(a, k: int):
    """a * k mod p for small k (used for 2x, 3x, 8x in point formulas)."""
    wide = u256.mul_small(a, k)  # 17 limbs
    lo, hi = wide[:NLIMBS], wide[NLIMBS]
    cols = [lo[i] for i in range(NLIMBS)]
    cols[0] = cols[0] + hi * jnp.uint32(_C)
    cols[2] = cols[2] + hi
    r, carry = u256.carry_propagate(cols, NLIMBS)
    cols = [r[i] for i in range(NLIMBS)]
    cols[0] = cols[0] + carry * jnp.uint32(_C)
    cols[2] = cols[2] + carry
    r2, _ = u256.carry_propagate(cols, NLIMBS)
    # k <= 8 keeps r2 < 2p after folds
    return normalize_weak_to_canonical(r2)


def pow_const(a, exponent: int):
    """a^exponent for a static exponent, as a data-driven MSB-first ladder.

    The ladder body (one square + one mul + select) traces ONCE and loops
    via fori_loop over a constant bit array -- an unrolled chain would emit
    hundreds of mul instances and take minutes to compile (XLA semantics:
    everything traced is compiled; keep hot structure in lax loops).
    """
    assert exponent >= 1
    nbits = exponent.bit_length()
    bits = jnp.asarray(
        [(exponent >> (nbits - 1 - i)) & 1 for i in range(nbits)], dtype=jnp.uint32
    )

    def body(i, r):
        r = square_weak(r)
        rm = mul_weak(r, a)
        return u256.select(bits[i] == 1, rm, r)

    # MSB is always 1: start at r = a, consume remaining bits.  Intermediates
    # stay weak (< 2^256); only the final value is normalized.
    return normalize_weak_to_canonical(jax.lax.fori_loop(1, nbits, body, a))


def inv(a):
    """a^(p-2): Fermat inversion via the secp256k1 addition chain.

    255 squarings + 15 multiplies (~270 sequential steps vs 510 for the
    binary ladder).  Square-runs use
    fori_loop to keep the trace at ~26 mul bodies.  Chain verified == p-2
    in tests.  The reference unrolls 256 square-and-multiply steps per
    element (shaders/field.wgsl:195-210)."""

    def sqn(x, n):
        if n <= 2:
            for _ in range(n):
                x = square_weak(x)
            return x
        return jax.lax.fori_loop(0, n, lambda _, v: square_weak(v), x)

    # the whole chain runs on weak (< 2^256) representatives; one final
    # normalize (inv callers feed the result into mul, which accepts weak,
    # but canonical output keeps the field API uniform)
    x1 = a
    x2 = mul_weak(sqn(x1, 1), x1)
    x3 = mul_weak(sqn(x2, 1), x1)
    x6 = mul_weak(sqn(x3, 3), x3)
    x9 = mul_weak(sqn(x6, 3), x3)
    x11 = mul_weak(sqn(x9, 2), x2)
    x22 = mul_weak(sqn(x11, 11), x11)
    x44 = mul_weak(sqn(x22, 22), x22)
    x88 = mul_weak(sqn(x44, 44), x44)
    x176 = mul_weak(sqn(x88, 88), x88)
    x220 = mul_weak(sqn(x176, 44), x44)
    x223 = mul_weak(sqn(x220, 3), x3)
    t = mul_weak(sqn(x223, 23), x22)
    t = mul_weak(sqn(t, 5), x1)
    t = mul_weak(sqn(t, 3), x2)
    t = mul_weak(sqn(t, 2), x1)
    return normalize_weak_to_canonical(t)


def batch_inverse_chain(values, chain_axis: int = 0, unroll: int = 1):
    """Montgomery batch inversion along axis `chain_axis` of a limb array.

    values: (16, C, *rest) with chain length C along the given batch axis
    (axis index counts batch dims, i.e. axis 0 is values.shape[1]).
    Returns elementwise inverses, same shape.  Zero inputs produce garbage
    in their own slot AND would poison the chain -- callers must pre-replace
    zeros (see curve.batch_normalize).

    The chain-total inverse is pow_const(., p-2): its ladder body is one
    square and one multiply, where inv's addition chain traces ~26
    multiplies -- on the gpu, compile time grows with every traced multiply
    (PERF.md), and the ladder runs once per dispatch over all chains.

    unroll: lax.scan unroll factor for the 2*C dependent mul steps (each
    unrolled step is one more traced multiply to compile).
    """
    assert chain_axis == 0, "chains run along the first batch axis"
    vals_t = jnp.moveaxis(values, 1, 0)  # (C, 16, *rest)
    ones = u256.constant(1, values.shape[2:])
    unroll = min(unroll, vals_t.shape[0])

    def fwd(carry, v):
        nxt = mul_weak(carry, v)
        return nxt, nxt

    # prefix[k] = v0*..*vk
    _, prefix = jax.lax.scan(fwd, ones, vals_t, unroll=unroll)
    total_inv = pow_const(prefix[-1], P_INT - 2)
    prefix_excl = jnp.concatenate([ones[None], prefix[:-1]], axis=0)

    def bwd(acc, xs):
        v, pex = xs
        inv_k = mul_weak(acc, pex)
        return mul_weak(acc, v), inv_k

    _, invs = jax.lax.scan(bwd, total_inv, (vals_t, prefix_excl),
                           reverse=True, unroll=unroll)
    # chain intermediates stay weak; one normalize for the canonical API
    return normalize_weak_to_canonical(jnp.moveaxis(invs, 0, 1))


def to_canonical_int_check(a) -> bool:
    """Host helper: True if all batch elements are canonical (< p)."""
    vals = u256.to_int(np.asarray(a).reshape(NLIMBS, -1))
    return all(v < P_INT for v in vals)
