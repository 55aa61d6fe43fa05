"""(V, T) 2D-batch trace paths vs flat (B,) paths: identical numerics.

The hash/encode/interval code is shape-polymorphic over the batch dims; the
same jnp code must produce the same results over (V, T) 2D batches as over
flat (B,) ones (tiny batches keep the XLA:CPU compiles fast).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from vgen_tpu.crypto.address import AddressFormat

B, V = 32, 4
T = B // V
RNG = np.random.RandomState(42)


def _limbs():
    return RNG.randint(0, 1 << 16, size=(16, B)).astype(np.uint32)


def _cmp(flat, tiled):
    flat = np.asarray(flat)
    tiled = np.asarray(tiled)
    assert flat.shape[:-1] == tiled.shape[:-2]
    np.testing.assert_array_equal(flat, tiled.reshape(flat.shape))


def test_symbols_p2pkh_word_path_vtile():
    from vgen_tpu.ops import pipeline

    x, y = _limbs(), _limbs()
    sf, lf = pipeline.symbols_p2pkh(jnp.asarray(x), jnp.asarray(y))
    st, lt = pipeline.symbols_p2pkh(
        jnp.asarray(x.reshape(16, V, T)), jnp.asarray(y.reshape(16, V, T)),
    )
    _cmp(sf, st)
    _cmp(lf, lt)


def test_glv_interval_mask_vtile():
    from vgen_tpu.ops import pipeline

    x = _limbs()
    lo = np.zeros((4, 5), dtype=np.uint32)
    hi = np.zeros((4, 5), dtype=np.uint32)
    lo[:, 4] = 1
    hi[0] = [1 << 28, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF]
    mf = pipeline.glv_interval_mask(
        AddressFormat.P2PKH, jnp.asarray(x), None, jnp.asarray(lo),
        jnp.asarray(hi),
    )
    mt = pipeline.glv_interval_mask(
        AddressFormat.P2PKH, jnp.asarray(x.reshape(16, V, T)), None,
        jnp.asarray(lo), jnp.asarray(hi),
    )
    _cmp(mf, mt)


def test_eth_symbols_vtile():
    from vgen_tpu.ops import pipeline

    x, y = _limbs(), _limbs()
    sf, lf = pipeline.symbols_ethereum(jnp.asarray(x), jnp.asarray(y))
    st, lt = pipeline.symbols_ethereum(
        jnp.asarray(x.reshape(16, V, T)), jnp.asarray(y.reshape(16, V, T)),
    )
    _cmp(sf, st)
    _cmp(lf, lt)


def test_tagged_hash_vtile():
    from vgen_tpu.ops import sha256, u256

    x = _limbs()
    mid = sha256.tagged_midstate("TapTweak")
    hf = sha256.tagged_hash_32(mid, u256.to_bytes_be(jnp.asarray(x)))
    ht = sha256.tagged_hash_32(
        mid, u256.to_bytes_be(jnp.asarray(x.reshape(16, V, T)))
    )
    _cmp(hf, ht)


def test_segwit_symbols_vtile():
    # bech32m over (V, T) batches: same numerics as the flat path
    from vgen_tpu.ops import encode, u256

    x = _limbs()
    sf, lf = encode.segwit_symbols(u256.to_bytes_be(jnp.asarray(x)), 1)
    st, lt = encode.segwit_symbols(
        u256.to_bytes_be(jnp.asarray(x.reshape(16, V, T))), 1
    )
    _cmp(sf, st)
    _cmp(lf, lt)
