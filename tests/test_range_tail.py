"""XLA interval tail (ops/pipeline.make_range_mask) vs the host oracle.

Covers every format (including P2TR's on-device TapTweak and Ethereum's
keccak path) and the GLV 6-variant expansion.  On the gpu the same helpers
are checked against the host oracle by chip_smoke.py (scan/oracle.py)."""

import numpy as np
import pytest

from vgen_tpu.crypto import secp256k1 as ec
from vgen_tpu.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu.ops import pipeline
from vgen_tpu.pattern import Pattern
from vgen_tpu.scan import tables

B = 256
BASE = 0x5EED5EED5EED
CHAIN = 16


def _run(fmt, pattern_str, glv=False):
    import jax.numpy as jnp

    tx, ty = tables.ig_table_limbs(B)
    pt = ec.scalar_mult(BASE)
    bx = jnp.asarray(tables._ints_to_limbs([pt[0]])[0])
    by = jnp.asarray(tables._ints_to_limbs([pt[1]])[0])
    pat = Pattern(pattern_str)
    ivs = pat.match_intervals(fmt)
    assert ivs is not None, (fmt, pattern_str)
    lo, hi = pipeline.intervals_to_words(
        ivs, pipeline.INTERVAL_WORDS[fmt]
    )
    extras = ()
    if fmt == AddressFormat.P2TR:
        extras = (jnp.asarray(tables.window_table_u32(8)),)
    res, _ = pipeline.run_window(
        fmt, "range", bx, by, jnp.asarray(tx), jnp.asarray(ty), B,
        (jnp.asarray(lo), jnp.asarray(hi)), extras, chain_len=CHAIN, glv=glv,
    )
    got = sorted(int(i) for i in np.asarray(res.indices) if i >= 0)
    return pat, got, int(res.count), int(res.ops)


def _oracle(fmt, pat, glv):
    gen = AddressGenerator(fmt)
    out = []
    for i in range(B):
        keys = (
            ec.glv_variant_keys(BASE + 1 + i) if glv else [BASE + 1 + i]
        )
        if any(
            pat.matches(gen.generate(k.to_bytes(32, "big")).address)
            for k in keys
        ):
            out.append(i)
    return out


@pytest.mark.parametrize(
    "fmt,pattern",
    [
        (AddressFormat.P2PKH, "^1C"),
        (AddressFormat.P2PKH_UNCOMPRESSED, "^1A"),
        (AddressFormat.P2SH_P2WPKH, "^3A"),
        (AddressFormat.P2WPKH, "^bc1qq"),
        (AddressFormat.P2TR, "^bc1pq"),
        (AddressFormat.ETHEREUM, "^0x1"),
    ],
)
def test_range_tail_vs_oracle(fmt, pattern):
    pat, got, count, ops = _run(fmt, pattern)
    expect = _oracle(fmt, pat, glv=False)
    assert got == expect[-pipeline.TOP_K:]
    assert count == len(expect)
    assert ops == B


@pytest.mark.parametrize(
    "fmt,pattern",
    [
        (AddressFormat.P2PKH, "^1C"),
        (AddressFormat.P2PKH_UNCOMPRESSED, "^1A"),
        (AddressFormat.ETHEREUM, "^0x1"),
    ],
)
def test_range_tail_glv_vs_oracle(fmt, pattern):
    pat, got, count, ops = _run(fmt, pattern, glv=True)
    expect = _oracle(fmt, pat, glv=True)
    assert got == expect[-pipeline.TOP_K:]
    assert count == len(expect)
    assert ops == 6 * B


@pytest.mark.parametrize(
    "fmt,pattern",
    [
        (AddressFormat.P2PKH_UNCOMPRESSED, "^1A"),
        (AddressFormat.ETHEREUM, "^0x1"),
    ],
)
def test_range_tail_glv_exact_y_vbits(fmt, pattern):
    """GLV_EXACT_Y formats hash the full (x, y): the reported variant bit
    2v+pi must resolve (parity_exact=True) to the exact matching key."""
    import jax.numpy as jnp

    tx, ty = tables.ig_table_limbs(B)
    pt = ec.scalar_mult(BASE)
    bx = jnp.asarray(tables._ints_to_limbs([pt[0]])[0])
    by = jnp.asarray(tables._ints_to_limbs([pt[1]])[0])
    pat = Pattern(pattern)
    ivs = pat.match_intervals(fmt)
    lo, hi = pipeline.intervals_to_words(ivs, pipeline.INTERVAL_WORDS[fmt])
    res, _ = pipeline.run_window(
        fmt, "range", bx, by, jnp.asarray(tx), jnp.asarray(ty), B,
        (jnp.asarray(lo), jnp.asarray(hi)), chain_len=CHAIN, glv=True,
    )
    gen = AddressGenerator(fmt)
    pairs = {
        int(i): int(b)
        for i, b in zip(np.asarray(res.indices), np.asarray(res.vbits))
        if i >= 0
    }
    assert pairs, "pattern should match some window position"
    for i, bits in pairs.items():
        key = BASE + 1 + i
        matching = {
            v for v in ec.glv_variant_keys(key)
            if pat.matches(gen.generate(v.to_bytes(32, "big")).address)
        }
        cands = set(ec.glv_bit_variant_keys(key, bits, parity_exact=True))
        assert matching <= cands, (i, bits, matching, cands)
        # exactness: every candidate the host would derive DOES match
        for c in cands:
            assert pat.matches(gen.generate(c.to_bytes(32, "big")).address)


def _run_dfa(fmt, pattern_str, glv=False):
    import jax.numpy as jnp

    tx, ty = tables.ig_table_limbs(B)
    pt = ec.scalar_mult(BASE)
    bx = jnp.asarray(tables._ints_to_limbs([pt[0]])[0])
    by = jnp.asarray(tables._ints_to_limbs([pt[1]])[0])
    pat = Pattern(pattern_str)
    dev = pat.device_dfa(fmt)
    flat, accept = pipeline.pad_device_dfa(dev)
    extras = ()
    if fmt == AddressFormat.P2TR:
        extras = (jnp.asarray(tables.window_table_u32(8)),)
    res, _ = pipeline.run_window(
        fmt, "dfa", bx, by, jnp.asarray(tx), jnp.asarray(ty), B,
        (jnp.asarray(flat), jnp.asarray(accept), jnp.int32(dev.start)),
        extras, chain_len=CHAIN, glv=glv,
    )
    got = sorted(int(i) for i in np.asarray(res.indices) if i >= 0)
    return pat, got, int(res.count), int(res.ops)


@pytest.mark.slow
@pytest.mark.parametrize(
    "fmt,pattern",
    [
        (AddressFormat.P2PKH, "^1C"),          # prefix via DFA
        (AddressFormat.P2PKH_UNCOMPRESSED, "^1A"),  # full-(x,y) hash
        (AddressFormat.P2WPKH, "q$"),          # suffix (non-interval)
        (AddressFormat.P2SH_P2WPKH, "^3[AB]"),
        (AddressFormat.ETHEREUM, "^0x[1Ff]"),  # EIP-55 cased class
    ],
)
def test_dfa_tail_glv_vs_oracle(fmt, pattern):
    """GLV 6-variant expansion on the generic DFA path (any regex)."""
    pat, got, count, ops = _run_dfa(fmt, pattern, glv=True)
    expect = _oracle(fmt, pat, glv=True)
    assert got == expect[-pipeline.TOP_K:]
    assert count == len(expect)
    assert ops == 6 * B
