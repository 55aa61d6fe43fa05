"""Property tests: device u256/field arithmetic vs Python big ints."""

import random
from functools import partial

import jax
import numpy as np
import pytest

from vgen_tpu.crypto.secp256k1 import P
from vgen_tpu.ops import field as _field
from vgen_tpu.ops import u256 as _u256

rng = random.Random(42)


class _Jitted:
    """Attribute-level jax.jit wrapper: eager dispatch of the unrolled limb
    kernels is minutes-slow; compiled they run in milliseconds."""

    def __init__(self, mod, static=()):
        self._mod = mod
        self._static = static
        self._cache = {}

    def __getattr__(self, name):
        fn = getattr(self._mod, name)
        if not callable(fn) or name in ("from_int", "to_int", "constant",
                                        "to_canonical_int_check"):
            return fn
        if name not in self._cache:
            static_argnums = self._static.get(name, ()) if isinstance(
                self._static, dict) else ()
            self._cache[name] = jax.jit(fn, static_argnums=static_argnums)
        return self._cache[name]


u256 = _Jitted(
    _u256,
    {"mul_small": (1,), "add_small": (1,), "shift_limbs_up": (1, 2),
     "get_byte_be": (1,), "to_bytes_be": (1,)},
)
field = _Jitted(_field, {"mul_small": (1,), "pow_const": (1,)})


def rand_ints(n, below=1 << 256):
    return [rng.randrange(below) for _ in range(n)]


def dev(vals, nlimbs=16):
    import jax.numpy as jnp

    return jnp.asarray(u256.from_int(vals, nlimbs))


# --- u256 -----------------------------------------------------------------

def test_from_to_int_roundtrip():
    vals = rand_ints(7) + [0, 1, (1 << 256) - 1]
    assert u256.to_int(u256.from_int(vals)) == vals


def test_add_sub():
    a, b = rand_ints(33), rand_ints(33)
    s, carry = u256.add(dev(a), dev(b))
    np.testing.assert_array_equal(
        u256.to_int(s), [(x + y) % (1 << 256) for x, y in zip(a, b)]
    )
    np.testing.assert_array_equal(
        np.asarray(carry), [(x + y) >> 256 for x, y in zip(a, b)]
    )
    d, borrow = u256.sub(dev(a), dev(b))
    np.testing.assert_array_equal(
        u256.to_int(d), [(x - y) % (1 << 256) for x, y in zip(a, b)]
    )
    np.testing.assert_array_equal(np.asarray(borrow), [int(x < y) for x, y in zip(a, b)])


def test_mul_wide():
    a, b = rand_ints(17), rand_ints(17)
    a += [0, (1 << 256) - 1]
    b += [0, (1 << 256) - 1]
    prod = u256.mul_wide(dev(a), dev(b))
    assert u256.to_int(prod) == [x * y for x, y in zip(a, b)]


def test_square_wide():
    a = rand_ints(17) + [0, (1 << 256) - 1, 3]
    sq = u256.square_wide(dev(a))
    assert u256.to_int(sq) == [x * x for x in a]


def test_mul_small():
    a = rand_ints(9) + [(1 << 256) - 1]
    for k in (0, 1, 2, 3, 8, 977, 65535):
        prod = u256.mul_small(dev(a), k)
        assert u256.to_int(prod) == [x * k for x in a]


def test_geq_iszero_eq_select():
    a = [5, 7, 7, 0, (1 << 256) - 1]
    b = [7, 7, 5, 0, 1]
    assert list(np.asarray(u256.geq(dev(a), dev(b)))) == [False, True, True, True, True]
    assert list(np.asarray(u256.is_zero(dev(a)))) == [False, False, False, True, False]
    assert list(np.asarray(u256.eq(dev(a), dev(b)))) == [False, True, False, True, False]
    mask = u256.geq(dev(a), dev(b))
    sel = u256.select(mask, dev(a), dev(b))
    assert u256.to_int(sel) == [7, 7, 7, 0, (1 << 256) - 1]


def test_bytes_be_roundtrip():
    vals = rand_ints(5)
    d = dev(vals)
    bts = u256.to_bytes_be(d)
    assert bts.shape == (32, 5)
    back = u256.from_bytes_be(bts)
    assert u256.to_int(back) == vals
    # spot-check byte order: most significant byte first
    v = vals[0]
    assert int(np.asarray(bts)[0, 0]) == (v >> 248) & 0xFF


# --- field mod p ----------------------------------------------------------

def fvals(n):
    out = rand_ints(n, P)
    out += [0, 1, P - 1, P - 2, 2**255 % P]
    return out


def test_field_add():
    a, b = fvals(20), fvals(20)
    s = field.add(dev(a), dev(b))
    assert u256.to_int(s) == [(x + y) % P for x, y in zip(a, b)]


def test_field_add_extreme():
    # stress the double-fold path near 2^256
    a = [P - 1] * 3 + [P - 977] + [2**255]
    b = [P - 1, 1, P - 2, P - 1, 2**255 % P]
    s = field.add(dev(a), dev(b))
    assert u256.to_int(s) == [(x + y) % P for x, y in zip(a, b)]


def test_field_sub():
    a, b = fvals(20), fvals(20)
    d = field.sub(dev(a), dev(b))
    assert u256.to_int(d) == [(x - y) % P for x, y in zip(a, b)]


def test_field_neg():
    a = fvals(10)
    n = field.neg(dev(a))
    assert u256.to_int(n) == [(-x) % P for x in a]


def test_field_mul():
    a, b = fvals(20), fvals(20)
    m = field.mul(dev(a), dev(b))
    assert u256.to_int(m) == [(x * y) % P for x, y in zip(a, b)]


def test_field_mul_adversarial():
    # values whose products land near fold boundaries
    a = [P - 1, P - 1, (1 << 255) % P, 977, 1 << 128, (P - 1) // 2]
    b = [P - 1, 1, (1 << 255) % P, 977, 1 << 128, 2]
    m = field.mul(dev(a), dev(b))
    assert u256.to_int(m) == [(x * y) % P for x, y in zip(a, b)]


def test_field_square():
    a = fvals(20)
    s = field.square(dev(a))
    assert u256.to_int(s) == [(x * x) % P for x in a]


def test_field_mul_small():
    a = fvals(10)
    for k in (2, 3, 4, 8):
        m = field.mul_small(dev(a), k)
        assert u256.to_int(m) == [(x * k) % P for x in a]


def test_field_inv():
    a = [x for x in fvals(10) if x != 0]
    iv = field.inv(dev(a))
    assert u256.to_int(iv) == [pow(x, P - 2, P) for x in a]


def test_field_pow_const():
    a = [x for x in fvals(5) if x != 0]
    e = 0xDEADBEEFCAFE
    r = field.pow_const(dev(a), e)
    assert u256.to_int(r) == [pow(x, e, P) for x in a]


def test_batch_inverse_chain():
    import jax.numpy as jnp

    C, R = 8, 3
    vals = [[rng.randrange(1, P) for _ in range(R)] for _ in range(C)]
    arr = jnp.stack([dev(row) for row in vals], axis=1)  # (16, C, R)
    invs = field.batch_inverse_chain(arr)
    assert invs.shape == (16, C, R)
    for c in range(C):
        got = u256.to_int(invs[:, c])
        assert got == [pow(v, P - 2, P) for v in vals[c]]


# Montgomery chain shapes the scanners use: one chain over a whole odd-sized
# batch, a single element, and zeros pre-replaced by one (the caller
# contract of curve.scalar_mul_add_windowed_affine).


def _inverse_chain_np(vals):
    return u256.to_int(np.asarray(field.batch_inverse_chain(dev(vals))))


def test_fallback_small_width_exact():
    r = random.Random(3)
    vals = [r.randrange(1, P - 1) for _ in range(96)]
    for v, g in zip(vals, _inverse_chain_np(vals)):
        assert (v * g) % P == 1


def test_fallback_width_one():
    v = 0xDEADBEEF12345
    assert (v * _inverse_chain_np([v])[0]) % P == 1


def test_fallback_guard_zero():
    """Zero lanes replaced by one before the chain (as the P2TR ladder
    does) leave every other inverse exact."""
    r = random.Random(7)
    vals = [r.randrange(1, P - 1) for _ in range(96)]
    for dead in (0, 17, 95):
        vals[dead] = 0
    got = _inverse_chain_np([v or 1 for v in vals])
    for v, g in zip(vals, got):
        if v:
            assert (v * g) % P == 1
        else:
            assert g == 1
