"""scan.oracle: the device mask vs host re-derivation check that chip_smoke
runs on the card at full width, here on the CPU backend at a tiny batch."""

import numpy as np
import pytest

from vgen_tpu.crypto import secp256k1 as ec
from vgen_tpu.crypto.address import AddressFormat as F
from vgen_tpu.crypto.address import AddressGenerator
from vgen_tpu.pattern import Pattern
from vgen_tpu.scan import oracle
from vgen_tpu.scan.route import Route

BATCH = 256
CHAIN = 16
BASE = 0x5EED0000D00D


@pytest.fixture(scope="module")
def runner():
    return oracle.WindowRunner(BATCH, CHAIN)


@pytest.mark.parametrize(
    "fmt,pattern",
    [
        (F.P2PKH, "^1[A-Za-z]"),  # GLV, compressed prefix parity
        (F.ETHEREUM, "^0x[0-7]"),  # GLV, exact +-y
        (F.P2TR, "^bc1p[qpzry9x8]"),  # no GLV, on-chip TapTweak
    ],
    ids=["p2pkh-glv", "ethereum-glv", "p2tr"],
)
def test_device_mask_matches_host(runner, fmt, pattern):
    res = oracle.check_window(runner, fmt, pattern, BASE, BATCH)
    assert res.ok, res.mismatches[:5]
    assert res.n_checked == BATCH
    assert res.n_host > 0 and res.n_device > 0


@pytest.mark.parametrize(
    "fmt,pattern",
    [
        (F.P2PKH, "^1[A-Za-z]"),  # GLV interval
        (F.P2WPKH, "[ac]$"),  # GLV DFA
        (F.P2TR, "^bc1p[qpzry9x8]"),  # no GLV
    ],
    ids=["p2pkh-glv", "p2wpkh-dfa-glv", "p2tr"],
)
def test_two_windows_per_dispatch_match_host(fmt, pattern):
    """k_sub=2, as the gpu batches its windows: every window of the
    dispatch is laid out against its own base point (a layout fault in
    window 1 would report matches at keys the host does not derive)."""
    two = oracle.WindowRunner(64, 16, k_sub=2)
    res = oracle.check_window(two, fmt, pattern, BASE, 64)
    assert res.ok, res.mismatches[:5]
    assert res.n_windows == 2
    assert res.n_checked == 2 * 64
    _, masks = two.mask(fmt, Pattern(pattern), BASE)
    masks = np.asarray(masks)
    assert masks.shape == (2, 64) and masks[1].any()
    # window 1 is the next window of the key space, not a copy of window 0
    one = oracle.WindowRunner(64, 16, k_sub=1)
    _, m1 = one.mask(fmt, Pattern(pattern), BASE + 64)
    np.testing.assert_array_equal(masks[1], np.asarray(m1)[0])


def test_expected_bits_plain_keys():
    fmt, pat = F.P2PKH, Pattern("^1[A-H]")
    keys = [BASE + i for i in range(40)]
    gen = AddressGenerator(fmt)
    want = [int(pat.matches(gen.generate(k.to_bytes(32, "big")).address))
            for k in keys]
    got = oracle.expected_bits(fmt, pat, keys, False,
                               oracle.HostAddresses(fmt))
    assert got == want and any(want)


@pytest.mark.parametrize("fmt", [F.P2PKH, F.ETHEREUM])
def test_expected_bits_glv_layout(fmt):
    """Bit 2v+pi names one variant key: the one derived from
    glv_bit_variant_keys, whose address must match."""
    pat = Pattern("^1[A-Z]" if fmt == F.P2PKH else "^0x[0-7]")
    exact = fmt == F.ETHEREUM
    gen = AddressGenerator(fmt)
    keys = [BASE + 7 * i for i in range(12)]
    bits = oracle.expected_bits(fmt, pat, keys, True,
                                oracle.HostAddresses(fmt))
    assert any(bits)
    for k, b in zip(keys, bits):
        for bit in range(6):
            if not b >> bit & 1:
                continue
            cands = ec.glv_bit_variant_keys(k, 1 << bit, parity_exact=exact)
            addrs = [gen.generate(c.to_bytes(32, "big")).address
                     for c in cands]
            assert any(pat.matches(a) for a in addrs)


class _FakeRunner:
    batch = BATCH

    def __init__(self, mask):
        self._mask = mask

    def mask(self, fmt, pattern, base):
        import jax.numpy as jnp

        return Route("range", False, 1), jnp.asarray(self._mask)[None]


def test_check_window_reports_a_flipped_bit():
    fmt, pat = F.P2WPKH, "^bc1q[qpzry9x8]"
    keys = [BASE + 1 + i for i in range(BATCH)]
    truth = oracle.expected_bits(fmt, Pattern(pat), keys, False,
                                 oracle.HostAddresses(fmt))
    mask = np.asarray(truth, dtype=np.int32)
    assert oracle.check_window(_FakeRunner(mask), fmt, pat, BASE, 64).ok
    mask[5] ^= 1
    res = oracle.check_window(_FakeRunner(mask), fmt, pat, BASE, 64)
    assert res.mismatches == [(5, int(mask[5]), truth[5])]


def test_cases_cover_six_formats_both_paths():
    assert {(f, p) for f, p, _ in oracle.CASES} == {
        (f, p) for f in F for p in ("range", "dfa")
    }
    for fmt, path, pat in oracle.CASES:
        exact = Pattern(pat).match_intervals(fmt)
        assert (exact is not None) == (path == "range"), (fmt, pat)


@pytest.mark.gpu
def test_full_width_oracle_on_gpu(gpu):
    """The oracle check at the CLI's width on the card (chip_smoke phase 2
    for one case)."""
    from vgen_tpu.scan.scanner import CHAIN_LEN, DEFAULT_DEVICE_BATCH

    full = oracle.WindowRunner(DEFAULT_DEVICE_BATCH, CHAIN_LEN, gpu)
    res = oracle.check_window(full, F.P2PKH, "^1Ab", BASE, 65_536)
    assert res.ok, res.mismatches[:5]
    assert res.n_host > 0
