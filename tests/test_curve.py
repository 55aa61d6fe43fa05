"""Device curve ops vs the host oracle."""

import random

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from vgen_tpu.crypto import secp256k1 as ec
from vgen_tpu.ops import curve, field, u256

rng = random.Random(7)


def dev_pts(points):
    xs = u256.from_int([p[0] for p in points])
    ys = u256.from_int([p[1] for p in points])
    return jnp.asarray(xs), jnp.asarray(ys)


def test_batch_affine_add_vs_oracle():
    base_k = rng.randrange(1, ec.N)
    base = ec.scalar_mult(base_k)
    B = 8
    table = ec.ig_table(B, start=1)
    tx, ty = dev_pts(table)
    bx = jnp.asarray(u256.from_int(base[0]))
    by = jnp.asarray(u256.from_int(base[1]))
    f = jax.jit(lambda *a: curve.batch_affine_add(*a, chain_len=4))
    x3, y3, valid = f(bx, by, tx, ty)
    assert all(np.asarray(valid))
    got_x = u256.to_int(x3)
    got_y = u256.to_int(y3)
    for i in range(B):
        expect = ec.scalar_mult(base_k + 1 + i)
        assert (got_x[i], got_y[i]) == expect, i


def test_batch_affine_add_degenerate_masked():
    # base == 3*G collides with table entry i=3
    base = ec.scalar_mult(3)
    table = ec.ig_table(4, start=1)
    tx, ty = dev_pts(table)
    bx = jnp.asarray(u256.from_int(base[0]))
    by = jnp.asarray(u256.from_int(base[1]))
    x3, y3, valid = jax.jit(lambda *a: curve.batch_affine_add(*a, chain_len=4))(
        bx, by, tx, ty
    )
    v = list(np.asarray(valid))
    assert v == [True, True, False, True]
    got_x = u256.to_int(x3)
    for i in (0, 1, 3):
        assert got_x[i] == ec.scalar_mult(3 + 1 + i)[0]


@pytest.mark.slow
def test_jacobian_double_add_vs_oracle():
    ks = [rng.randrange(1, ec.N) for _ in range(4)]
    pts = [ec.scalar_mult(k) for k in ks]
    X, Y = dev_pts(pts)
    Z = u256.constant(1, (4,))
    dX, dY, dZ = jax.jit(curve.jacobian_double)(X, Y, Z)
    ax, ay = jax.jit(curve.jacobian_to_affine)(dX, dY, dZ)
    for i, k in enumerate(ks):
        assert (u256.to_int(ax)[i], u256.to_int(ay)[i]) == ec.scalar_mult(2 * k)

    # mixed add: P + G
    gx = jnp.asarray(u256.from_int([ec.GX] * 4))
    gy = jnp.asarray(u256.from_int([ec.GY] * 4))
    aX, aY, aZ = jax.jit(curve.jacobian_add_affine)(X, Y, Z, gx, gy)
    ax, ay = jax.jit(curve.jacobian_to_affine)(aX, aY, aZ)
    for i, k in enumerate(ks):
        assert (u256.to_int(ax)[i], u256.to_int(ay)[i]) == ec.scalar_mult(k + 1)


@pytest.mark.slow
def test_jacobian_add_affine_doubling_case():
    # P == Q triggers the branch-free doubling select
    pts = [ec.scalar_mult(5)] * 2
    X, Y = dev_pts(pts)
    Z = u256.constant(1, (2,))
    gx = jnp.asarray(u256.from_int([pts[0][0]] * 2))
    gy = jnp.asarray(u256.from_int([pts[0][1]] * 2))
    aX, aY, aZ = jax.jit(curve.jacobian_add_affine)(X, Y, Z, gx, gy)
    ax, ay = jax.jit(curve.jacobian_to_affine)(aX, aY, aZ)
    assert (u256.to_int(ax)[0], u256.to_int(ay)[0]) == ec.scalar_mult(10)


@pytest.mark.slow
def test_jacobian_add_affine_inverse_case():
    # P == -Q -> infinity (Z == 0)
    p5 = ec.scalar_mult(5)
    X, Y = dev_pts([p5])
    Z = u256.constant(1, (1,))
    neg = ec.point_neg(p5)
    gx = jnp.asarray(u256.from_int([neg[0]]))
    gy = jnp.asarray(u256.from_int([neg[1]]))
    _, _, aZ = jax.jit(curve.jacobian_add_affine)(X, Y, Z, gx, gy)
    assert u256.to_int(aZ)[0] == 0


@pytest.mark.slow
def test_jacobian_add_affine_from_infinity():
    # Z1 == 0 with z1_is_zero mask -> result is Q
    X = u256.constant(0, (1,))
    Y = u256.constant(0, (1,))
    Z = u256.constant(0, (1,))
    gx = jnp.asarray(u256.from_int([ec.GX]))
    gy = jnp.asarray(u256.from_int([ec.GY]))
    zmask = jnp.asarray([True])
    aX, aY, aZ = jax.jit(curve.jacobian_add_affine)(X, Y, Z, gx, gy, zmask)
    assert u256.to_int(aX)[0] == ec.GX
    assert u256.to_int(aZ)[0] == 1


def test_batch_jacobian_to_affine():
    ks = [rng.randrange(1, ec.N) for _ in range(8)]
    pts = [ec.scalar_mult(k) for k in ks]
    X, Y = dev_pts(pts)
    Z = u256.constant(1, (8,))
    # scramble into random Jacobian representatives: X*z^2, Y*z^3, z
    zs = [rng.randrange(1, ec.P) for _ in range(8)]
    zd = jnp.asarray(u256.from_int(zs))
    z2 = field.square(zd)
    Xs = field.mul(X, z2)
    Ys = field.mul(Y, field.mul(z2, zd))
    ax, ay = jax.jit(lambda *a: curve.batch_jacobian_to_affine(*a, chain_len=4))(
        Xs, Ys, zd
    )
    assert u256.to_int(ax) == [p[0] for p in pts]
    assert u256.to_int(ay) == [p[1] for p in pts]


def test_window_table_entries():
    tbl = ec.window_table(8)
    assert tbl.shape == (32, 256, 2, 16)
    # spot-check a few entries against scalar_mult
    for w, d in ((0, 1), (0, 7), (3, 200), (31, 255)):
        expect = ec.scalar_mult(d * pow(2, 8 * w, ec.N) % ec.N)
        x = sum(int(tbl[w, d, 0, i]) << (16 * i) for i in range(16))
        y = sum(int(tbl[w, d, 1, i]) << (16 * i) for i in range(16))
        assert (x, y) == expect, (w, d)


@pytest.mark.slow
def test_scalar_mul_windowed():
    tbl = jnp.asarray(ec.window_table(8))
    ks = [1, 2, rng.randrange(1, ec.N), ec.N - 1, 0xDEADBEEF]
    scal = jnp.asarray(u256.from_int(ks))
    f = jax.jit(lambda s: curve.scalar_mul_windowed(s, tbl, 8))
    X, Y, Z = f(scal)
    ax, ay = jax.jit(curve.jacobian_to_affine)(X, Y, Z)
    for i, k in enumerate(ks):
        expect = ec.scalar_mult(k)
        assert (u256.to_int(ax)[i], u256.to_int(ay)[i]) == expect, hex(k)


@pytest.mark.slow
def test_scalar_mul_add_windowed_affine():
    """Affine-accumulated Q = P + t*G (the P2TR tweak ladder) vs oracle."""
    tbl = jnp.asarray(ec.window_table(8))
    ps = [rng.randrange(1, ec.N) for _ in range(3)] + [5]
    ts = [1, rng.randrange(1, ec.N), ec.N - 1, 0xDEADBEEF]
    pts = [ec.scalar_mult(p) for p in ps]
    px = jnp.asarray(u256.from_int([pt[0] for pt in pts]))
    py = jnp.asarray(u256.from_int([pt[1] for pt in pts]))
    scal = jnp.asarray(u256.from_int(ts))
    f = jax.jit(
        lambda s, x, y: curve.scalar_mul_add_windowed_affine(s, tbl, x, y, 8)
    )
    qx, qy, ok = f(scal, px, py)
    assert np.asarray(ok).all()
    for i, (p, t) in enumerate(zip(ps, ts)):
        expect = ec.scalar_mult((p + t) % ec.N)
        assert (u256.to_int(qx)[i], u256.to_int(qy)[i]) == expect, (p, t)


def test_glv_endomorphism_constants():
    # BETA is a primitive cube root of 1 in F_p, LAMBDA in Z_n, and the
    # endomorphism law phi(x, y) = (BETA*x, y) == LAMBDA*(x, y) holds.
    assert pow(ec.BETA, 3, ec.P) == 1 and ec.BETA != 1
    assert pow(ec.LAMBDA, 3, ec.N) == 1 and ec.LAMBDA != 1
    assert ec.BETA2 == pow(ec.BETA, 2, ec.P)
    assert ec.LAMBDA2 == pow(ec.LAMBDA, 2, ec.N)
    for k in (1, 2, rng.randrange(1, ec.N)):
        x, y = ec.scalar_mult(k)
        lx, ly = ec.scalar_mult(ec.LAMBDA * k % ec.N)
        assert (lx, ly) == (ec.BETA * x % ec.P, y)
        l2x, l2y = ec.scalar_mult(ec.LAMBDA2 * k % ec.N)
        assert (l2x, l2y) == (ec.BETA2 * x % ec.P, y)


def test_glv_variant_keys():
    k = rng.randrange(1, ec.N)
    x, _ = ec.scalar_mult(k)
    variants = ec.glv_variant_keys(k)
    assert len(variants) == 6
    xs = {ec.scalar_mult(v)[0] for v in variants}
    assert xs == {x, ec.BETA * x % ec.P, ec.BETA2 * x % ec.P}
    # negation pairs share x; ordering is (v, -v) per lambda power
    for i in range(3):
        assert (variants[2 * i] + variants[2 * i + 1]) % ec.N == 0
