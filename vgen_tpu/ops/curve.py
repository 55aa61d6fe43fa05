"""Batched secp256k1 curve operations on the device.

The scan hot loop uses *affine incremental addition*: per batch we hold one
affine base point B = k*G and a replicated affine table T[i] = i*G, and
compute P_i = B + T[i] with a single scan-batched modular inversion shared
across the whole batch (Montgomery batch inversion over chunked chains).
That is ~6 field muls per key vs the reference's Jacobian mixed-add +
per-thread fe_inv (shaders/search.wgsl:3-31) or 256-wide workgroup batch
inversion (search.wgsl:59-135).

Also provides Jacobian double/add and a fixed-window scalar ladder for the
P2TR tweak path, where every key needs its own t*G multiplication.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from vgen_tpu.ops import field, u256


def affine_add_batch(bx, by, tx, ty, inv_dx):
    """P = B + T given precomputed inv_dx = 1/(tx - bx).

    All args (16, *batch).  Caller guarantees tx != bx via masking.
    2 muls + 1 square per element beyond the shared batch inversion.
    """
    # weak-value chain: sub() tolerates a weak (< 2^256) first argument, so
    # only x3/y3 pay a canonicalizing subtract (lam/square stay weak)
    lam = field.mul_weak(field.sub(ty, by), inv_dx)
    x3 = field.normalize_weak_to_canonical(
        field.sub(field.sub(field.square_weak(lam), bx), tx)
    )
    y3 = field.normalize_weak_to_canonical(
        field.sub(field.mul_weak(lam, field.sub(bx, x3)), by)
    )
    return x3, y3


def batch_affine_add(bx, by, tx, ty, chain_len: int = 256):
    """B + T[i] for a whole batch with one field inversion per chain.

    bx, by: (16,) or (16, *batch) base point (broadcast against table).
    tx, ty: (16, B) table points.
    Returns (x3, y3, valid) where valid is False where tx == bx (the
    doubling/inverse degenerate case -- vanishing probability, masked out).
    """
    B = tx.shape[1]
    if bx.ndim == 1:
        bx = bx[:, None]
        by = by[:, None]
    dx = field.sub(tx, bx)
    valid = ~u256.is_zero(dx)
    # guard zeros so they don't poison the inversion chains
    dx_safe = u256.select(valid, dx, u256.constant(1, dx.shape[1:]))
    # chunk into chains: (16, C, B//C)
    C = min(chain_len, B)
    assert B % C == 0, "batch must divide by chain length"
    dx_c = dx_safe.reshape(16, C, B // C)
    inv_c = field.batch_inverse_chain(dx_c)
    inv_dx = inv_c.reshape(16, B)
    x3, y3 = affine_add_batch(bx, by, tx, ty, inv_dx)
    return x3, y3, valid


# ---------------------------------------------------------------------------
# Jacobian arithmetic (for base-point stepping and the P2TR ladder)
# ---------------------------------------------------------------------------

def jacobian_double(X1, Y1, Z1):
    """dbl-2009-l for a=0: 1M + 5S-ish in field ops."""
    A = field.square(X1)
    Bv = field.square(Y1)
    C = field.square(Bv)
    t = field.square(field.add(X1, Bv))
    D = field.mul_small(field.sub(field.sub(t, A), C), 2)
    E = field.mul_small(A, 3)
    F = field.square(E)
    X3 = field.sub(F, field.mul_small(D, 2))
    Y3 = field.sub(field.mul(E, field.sub(D, X3)), field.mul_small(C, 8))
    Z3 = field.mul_small(field.mul(Y1, Z1), 2)
    return X3, Y3, Z3


def jacobian_add_affine(X1, Y1, Z1, x2, y2, z1_is_zero=None):
    """Mixed add P(Jacobian) + Q(affine), branch-free.

    Handles: P == infinity (Z1 == 0, when z1_is_zero given) -> Q;
             H == 0 and r == 0 (P == Q) -> doubling;
             H == 0 and r != 0 (P == -Q) -> infinity (Z3 = 0).
    """
    Z1Z1 = field.square(Z1)
    U2 = field.mul(x2, Z1Z1)
    S2 = field.mul(field.mul(y2, Z1), Z1Z1)
    H = field.sub(U2, X1)
    r = field.sub(S2, Y1)
    h_zero = u256.is_zero(H)
    r_zero = u256.is_zero(r)

    HH = field.square(H)
    HHH = field.mul(H, HH)
    V = field.mul(X1, HH)
    X3 = field.sub(field.sub(field.square(r), HHH), field.mul_small(V, 2))
    Y3 = field.sub(field.mul(r, field.sub(V, X3)), field.mul(Y1, HHH))
    Z3 = field.mul(Z1, H)

    dX, dY, dZ = jacobian_double(X1, Y1, Z1)
    X3 = u256.select(h_zero & r_zero, dX, X3)
    Y3 = u256.select(h_zero & r_zero, dY, Y3)
    Z3 = u256.select(h_zero & r_zero, dZ, Z3)
    # P == -Q: result is infinity (Z == 0)
    inf_mask = h_zero & ~r_zero
    Z3 = u256.select(inf_mask, u256.constant(0, Z3.shape[1:]), Z3)

    if z1_is_zero is not None:
        one = u256.constant(1, X3.shape[1:])
        X3 = u256.select(z1_is_zero, x2, X3)
        Y3 = u256.select(z1_is_zero, y2, Y3)
        Z3 = u256.select(z1_is_zero, one, Z3)
    return X3, Y3, Z3


def jacobian_to_affine(X, Y, Z):
    """Single-point normalization (one inversion)."""
    zi = field.inv(Z)
    zi2 = field.square(zi)
    return field.mul(X, zi2), field.mul(Y, field.mul(zi2, zi))


def batch_jacobian_to_affine(X, Y, Z, chain_len: int = 256):
    """Batch normalization via chained Montgomery inversion.

    X, Y, Z: (16, B).  Z must be nonzero (guard upstream).
    """
    B = X.shape[1]
    C = min(chain_len, B)
    assert B % C == 0
    zi = field.batch_inverse_chain(Z.reshape(16, C, B // C)).reshape(16, B)
    zi2 = field.square(zi)
    return field.mul(X, zi2), field.mul(Y, field.mul(zi2, zi))


def scalar_mul_windowed(scalar_limbs, table, window_bits: int = 8):
    """t*G per batch element via fixed windows over a precomputed table.

    scalar_limbs: (16, B) scalars (16-bit limbs, little-endian).
    table: (n_windows, 2^w, 2, 16) f32/uint32 array with table[w, d] =
           (d * 2^(w*window_bits)) * G affine (d=0 entry is unused filler;
           selection masks it to the identity).
    Returns Jacobian (X, Y, Z) with Z == 0 iff the accumulated sum is
    infinity (scalar == 0).

    Used by the P2TR tweak path: the reference leaves this on the CPU
    (gpu.rs:1288-1291 tweaks each candidate with the bitcoin crate); here it
    runs on the device.  Window digits select table rows with a one-hot
    matmul (a gather from the table is the alternative form).
    """
    assert window_bits in (4, 8, 16)
    B = scalar_limbs.shape[1]
    n_windows = 256 // window_bits
    digits_per_limb = 16 // window_bits

    tbl = table.astype(jnp.float32)  # (W, D, 2, 16)
    D = tbl.shape[1]

    init = (
        u256.constant(0, (B,)),
        u256.constant(0, (B,)),
        u256.constant(0, (B,)),
        jnp.ones((B,), dtype=bool),
    )

    def body(w, carry):
        X, Y, Z, z_zero = carry
        limb = jax.lax.dynamic_index_in_dim(
            scalar_limbs, w // digits_per_limb, axis=0, keepdims=False
        )
        shift = (jnp.uint32(w) % digits_per_limb) * window_bits
        digit = (limb >> shift) & jnp.uint32(D - 1)  # (B,)
        onehot = jax.nn.one_hot(digit, D, dtype=jnp.float32)  # (B, D)
        tblw = jax.lax.dynamic_index_in_dim(tbl, w, axis=0, keepdims=False)
        # select the 16-bit limbs via two byte-plane contractions, exact
        # under TF32 (see scalar_mul_add_windowed_affine)
        tbl_lo = tblw % 256.0
        tbl_hi = jnp.floor(tblw / 256.0)
        sel = (
            jnp.einsum("bd,dcl->bcl", onehot, tbl_lo)
            + 256.0 * jnp.einsum("bd,dcl->bcl", onehot, tbl_hi)
        )  # (B, 2, 16) exact
        px = jnp.transpose(sel[:, 0, :]).astype(jnp.uint32)  # (16, B)
        py = jnp.transpose(sel[:, 1, :]).astype(jnp.uint32)
        nonzero = digit != 0
        Xn, Yn, Zn = jacobian_add_affine(X, Y, Z, px, py, z1_is_zero=z_zero)
        # only apply when this window digit is nonzero
        X = u256.select(nonzero, Xn, X)
        Y = u256.select(nonzero, Yn, Y)
        Z = u256.select(nonzero, Zn, Z)
        return (X, Y, Z, z_zero & ~nonzero)

    X, Y, Z, _ = jax.lax.fori_loop(0, n_windows, body, init)
    return X, Y, Z


def scalar_mul_add_windowed_affine(scalar_limbs, table, px, py,
                                   window_bits: int = 8,
                                   chain_len: int = 256):
    """Q = (px, py) + t*G fully in AFFINE coordinates: each of the 256/w
    window adds shares ONE Montgomery batch inversion across the batch.

    Affine accumulation costs ~6M+1S per add (3M amortized inversion + the
    2M+1S mixed-add finish) vs ~8M+3S for the Jacobian mixed add, starts
    from the real point (px, py) so the identity never occurs, and the
    result needs NO final normalization inversion.  (The reference tweaks
    per candidate on the CPU, gpu.rs:1288-1291; the earlier Jacobian ladder
    here is scalar_mul_windowed.)

    Returns (qx, qy, ok): ok=False marks the (vanishing-probability) cases
    where an accumulator x-collision with a table point would need a
    doubling/inverse formula -- callers drop those candidates, mirroring
    how dx==0 is masked in the scan kernels.
    """
    assert window_bits in (4, 8, 16)
    B = scalar_limbs.shape[1]
    n_windows = 256 // window_bits
    digits_per_limb = 16 // window_bits

    tbl = table.astype(jnp.float32)  # (W, D, 2, 16)
    D = tbl.shape[1]
    C = min(chain_len, B)
    if B % C:
        C = B  # one chain over the whole batch (odd test sizes)
    ones = u256.constant(1, (B,))

    def body(w, carry):
        ax, ay, ok = carry
        limb = jax.lax.dynamic_index_in_dim(
            scalar_limbs, w // digits_per_limb, axis=0, keepdims=False
        )
        shift = (jnp.uint32(w) % digits_per_limb) * window_bits
        digit = (limb >> shift) & jnp.uint32(D - 1)  # (B,)
        onehot = jax.nn.one_hot(digit, D, dtype=jnp.float32)  # (B, D)
        tblw = jax.lax.dynamic_index_in_dim(tbl, w, axis=0, keepdims=False)
        tbl_lo = tblw % 256.0
        tbl_hi = jnp.floor(tblw / 256.0)
        sel = (
            jnp.einsum("bd,dcl->bcl", onehot, tbl_lo)
            + 256.0 * jnp.einsum("bd,dcl->bcl", onehot, tbl_hi)
        )  # (B, 2, 16) exact: precision DEFAULT is TF32 on the gpu (11-bit
        # significand, exact below 2^11); one-hot 0/1 times byte planes
        # <= 255, one nonzero product per output
        tx = jnp.transpose(sel[:, 0, :]).astype(jnp.uint32)  # (16, B)
        ty = jnp.transpose(sel[:, 1, :]).astype(jnp.uint32)
        nonzero = digit != 0
        dx = field.sub(tx, ax)
        dx_nz = ~u256.is_zero(dx)
        ok = ok & (dx_nz | ~nonzero)
        dx_safe = u256.select(dx_nz, dx, ones)
        # 32 inversions per key: unroll the chain steps 8-fold so each
        # window launches 2*C/8 loop iterations, not 2*C
        inv = field.batch_inverse_chain(
            dx_safe.reshape(16, C, B // C), unroll=8
        ).reshape(16, B)
        x3, y3 = affine_add_batch(ax, ay, tx, ty, inv)
        ax = u256.select(nonzero, x3, ax)
        ay = u256.select(nonzero, y3, ay)
        return ax, ay, ok

    ax, ay, ok = jax.lax.fori_loop(
        0, n_windows, body, (px, py, jnp.ones((B,), dtype=bool))
    )
    return ax, ay, ok
