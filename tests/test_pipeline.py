"""End-to-end device pipeline tests: every format, device matches == oracle."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vgen_tpu.crypto import secp256k1 as ec
from vgen_tpu.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu.ops import pipeline, u256
from vgen_tpu.pattern import Pattern

rng = random.Random(21)
B = 32  # batch for tests
CHAIN = 8

_window_tbl = None


def window_tbl():
    global _window_tbl
    if _window_tbl is None:
        _window_tbl = jnp.asarray(ec.window_table(8))
    return _window_tbl


def make_table(base_k):
    pts = ec.ig_table(B, start=1)
    tx = jnp.asarray(u256.from_int([p[0] for p in pts]))
    ty = jnp.asarray(u256.from_int([p[1] for p in pts]))
    base = ec.scalar_mult(base_k)
    bx = jnp.asarray(u256.from_int(base[0]))
    by = jnp.asarray(u256.from_int(base[1]))
    return bx, by, tx, ty


def run_step(fmt, pattern, base_k, remaining=B, ignore_case=False):
    pat = Pattern(pattern, ignore_case)
    dev = pat.device_dfa(fmt)
    flat, accept = pipeline.pad_device_dfa(dev)
    bx, by, tx, ty = make_table(base_k)
    extras = (window_tbl(),) if fmt == AddressFormat.P2TR else ()
    res, _ = pipeline.run_window(
        fmt, "dfa", bx, by, tx, ty, remaining,
        (jnp.asarray(flat), jnp.asarray(accept), jnp.int32(dev.start)),
        extras, chain_len=CHAIN,
    )
    return pat, res


def oracle_addresses(fmt, base_k, n=B):
    gen = AddressGenerator(fmt)
    out = []
    for i in range(n):
        secret = (base_k + 1 + i).to_bytes(32, "big")
        out.append(gen.generate(secret).address)
    return out


def expected_indices(pat, addrs, remaining=B):
    return sorted(
        i for i, a in enumerate(addrs) if i < remaining and pat.matches(a)
    )


def got_indices(res):
    idx = [int(v) for v in np.asarray(res.indices) if v >= 0]
    assert len(idx) == int(res.count) or int(res.count) > pipeline.TOP_K
    return sorted(idx)


FORMATS_FAST = [
    AddressFormat.P2PKH,
    AddressFormat.P2WPKH,
    AddressFormat.P2SH_P2WPKH,
    AddressFormat.ETHEREUM,
    AddressFormat.P2PKH_UNCOMPRESSED,
]


@pytest.mark.parametrize("fmt", FORMATS_FAST)
def test_match_all_pattern(fmt):
    """'.' matches everything -> all B keys match."""
    base_k = rng.randrange(1, ec.N - B - 1)
    pat, res = run_step(fmt, ".", base_k)
    assert int(res.count) == B
    assert int(res.ops) == B


@pytest.mark.parametrize("fmt", FORMATS_FAST)
def test_selective_pattern_matches_oracle(fmt):
    """A pattern matching a strict subset: device indices == oracle indices."""
    base_k = rng.randrange(1, ec.N - B - 1)
    addrs = oracle_addresses(fmt, base_k)
    # build a pattern from a real address so at least one hit exists:
    # match on the 2nd..4th chars of a known address
    probe = addrs[B // 2]
    prefix_len = {"1": 4, "3": 4, "b": 6, "0": 5}[probe[0]]
    pattern = "^" + probe[:prefix_len].replace("0x", "0x")
    import re

    pattern = "^" + re.escape(probe[:prefix_len])
    pat, res = run_step(fmt, pattern, base_k)
    expect = expected_indices(pat, addrs)
    assert B // 2 in expect
    assert got_indices(res) == expect


def test_p2tr_match_all():
    base_k = rng.randrange(1, ec.N - B - 1)
    pat, res = run_step(AddressFormat.P2TR, "^bc1p", base_k)
    assert int(res.count) == B


def test_p2tr_selective():
    base_k = rng.randrange(1, ec.N - B - 1)
    addrs = oracle_addresses(AddressFormat.P2TR, base_k)
    import re

    probe = addrs[3]
    pattern = "^" + re.escape(probe[:7])
    pat, res = run_step(AddressFormat.P2TR, pattern, base_k)
    expect = expected_indices(pat, addrs)
    assert 3 in expect
    assert got_indices(res) == expect


def test_remaining_mask():
    base_k = rng.randrange(1, ec.N - B - 1)
    pat, res = run_step(AddressFormat.P2PKH, ".", base_k, remaining=10)
    assert int(res.count) == 10
    assert int(res.ops) == 10
    assert all(i < 10 for i in got_indices(res))


def test_case_insensitive_pipeline():
    base_k = rng.randrange(1, ec.N - B - 1)
    addrs = oracle_addresses(AddressFormat.P2PKH, base_k)
    probe = addrs[5][1:4]  # 3 chars after the '1'
    pat, res = run_step(
        AddressFormat.P2PKH, "^1" + probe.swapcase(), base_k, ignore_case=True
    )
    expect = expected_indices(pat, addrs)
    assert 5 in expect
    assert got_indices(res) == expect


def test_suffix_anchor_pipeline():
    base_k = rng.randrange(1, ec.N - B - 1)
    addrs = oracle_addresses(AddressFormat.P2WPKH, base_k)
    probe = addrs[7][-3:]
    import re

    pat, res = run_step(AddressFormat.P2WPKH, re.escape(probe) + "$", base_k)
    expect = expected_indices(pat, addrs)
    assert 7 in expect
    assert got_indices(res) == expect


@pytest.mark.parametrize("scenario", ["empty", "sparse", "dense",
                                      "clustered", "exact16", "tail_block"])
def test_top_k_two_stage_exact(scenario):
    """top_k_match_indices must equal lax.top_k exactly for every match
    distribution, including >TOP_K matches clustered inside one block."""
    B = 32768  # 64 blocks of 512: exercises the two-stage path
    r = np.random.default_rng(hash(scenario) % 2**32)
    scores = np.full(B, -1, dtype=np.int32)
    if scenario == "sparse":
        hits = r.choice(B, size=5, replace=False)
    elif scenario == "dense":
        hits = r.choice(B, size=700, replace=False)
    elif scenario == "clustered":
        hits = np.arange(B - 40, B)  # all top-K in the last block
    elif scenario == "exact16":
        hits = r.choice(B, size=16, replace=False)
    elif scenario == "tail_block":
        hits = np.concatenate([np.arange(20), [B - 1]])
    else:
        hits = np.array([], dtype=np.int64)
    scores[hits.astype(np.int64)] = hits.astype(np.int32)
    sj = jnp.asarray(scores)
    got = np.asarray(pipeline.top_k_match_indices(sj))
    ref, _ = jax.lax.top_k(sj, pipeline.TOP_K)
    np.testing.assert_array_equal(got, np.asarray(ref))
