"""Interval compilation (pattern/intervals.py): soundness vs the host oracle.

Contract under test: for every address format, if an address matches the
anchored-literal pattern then its hashed payload value lies inside the
compiled interval union (NO false negatives); false positives are allowed
only within the checksum-widening slack (they are filtered by host
re-derivation in the scan drain path)."""

import random

import pytest

from vgen_tpu.crypto.address import AddressFormat
from vgen_tpu.crypto.encode import base58check_encode, segwit_addr_encode
from vgen_tpu.crypto.hashes import keccak256
from vgen_tpu.pattern import Pattern
from vgen_tpu.pattern.intervals import literal_prefix, match_intervals


def _p2pkh(h):
    return base58check_encode(b"\x00" + h.to_bytes(20, "big"))


def _p2sh(h):
    return base58check_encode(b"\x05" + h.to_bytes(20, "big"))


def _p2wpkh(h):
    return segwit_addr_encode("bc", 0, h.to_bytes(20, "big"))


def _p2tr(x):
    return segwit_addr_encode("bc", 1, x.to_bytes(32, "big"))


def _eth(h):
    raw = h.to_bytes(20, "big").hex()
    digest = keccak256(raw.encode()).hex()
    return "0x" + "".join(
        c.upper() if c.isalpha() and int(digest[i], 16) >= 8 else c
        for i, c in enumerate(raw)
    )


def test_literal_prefix_extraction():
    assert literal_prefix("^1Cat") == "1Cat"
    assert literal_prefix("^1Cat.*") == "1Cat"
    assert literal_prefix("^") == ""
    assert literal_prefix("1Cat") is None  # unanchored
    assert literal_prefix("^1C[ab]") is None  # class
    assert literal_prefix("^1C+") is None  # metachar
    assert literal_prefix("^1C$") is None  # end anchor


@pytest.mark.parametrize(
    "prefix,fmt,addrfn,bits",
    [
        ("1C", AddressFormat.P2PKH, _p2pkh, 160),
        ("1Cat", AddressFormat.P2PKH, _p2pkh, 160),
        ("1", AddressFormat.P2PKH, _p2pkh, 160),
        ("11", AddressFormat.P2PKH, _p2pkh, 160),
        ("111z", AddressFormat.P2PKH, _p2pkh, 160),
        ("3AB", AddressFormat.P2SH_P2WPKH, _p2sh, 160),
        ("bc1qme", AddressFormat.P2WPKH, _p2wpkh, 160),
        ("bc1q", AddressFormat.P2WPKH, _p2wpkh, 160),
        ("bc1pxyz", AddressFormat.P2TR, _p2tr, 256),
        ("0x1234", AddressFormat.ETHEREUM, _eth, 160),
    ],
)
def test_no_false_negatives(prefix, fmt, addrfn, bits):
    ivs = match_intervals(fmt, "^" + prefix, False)
    assert ivs is not None
    rng = random.Random(20260817)
    samples = [rng.getrandbits(bits) for _ in range(800)]
    samples += [rng.getrandbits(b) for b in (16, 64, 152) for _ in range(100)]
    for lo, hi in ivs:
        for d in (-1, 0, 1):
            for v in (lo + d, hi + d):
                if 0 <= v < (1 << bits):
                    samples.append(v)
    false_pos = 0
    for h in samples:
        addr = addrfn(h)
        m = addr.startswith(prefix)
        iv = any(lo <= h <= hi for lo, hi in ivs)
        assert not (m and not iv), f"false negative: {addr} h={h:#x}"
        if iv and not m:
            false_pos += 1
    # widening slack only: a handful of boundary values at most
    assert false_pos <= 4 * len(ivs) + 4


def test_unsatisfiable_prefixes():
    # '2' is not a P2PKH lead char; bc1p is the wrong witness version
    assert match_intervals(AddressFormat.P2PKH, "^2", False) == ()
    assert match_intervals(AddressFormat.P2WPKH, "^bc1p", False) == ()
    assert match_intervals(AddressFormat.ETHEREUM, "^1x", False) == ()


def test_non_literal_falls_back():
    assert match_intervals(AddressFormat.P2PKH, "^1[CD]at", False) is None
    assert match_intervals(AddressFormat.P2PKH, "Cat", False) is None
    # base58 is case-significant: case-insensitive literals use the DFA
    assert match_intervals(AddressFormat.P2PKH, "^1Cat", True) is None


def test_case_insensitive_bech32_folds():
    ivs_u = match_intervals(AddressFormat.P2WPKH, "^BC1QME", True)
    ivs_l = match_intervals(AddressFormat.P2WPKH, "^bc1qme", False)
    assert ivs_u == ivs_l


def test_eth_case_insensitive_and_x():
    ivs = match_intervals(AddressFormat.ETHEREUM, "^0XAB", True)
    assert ivs == match_intervals(AddressFormat.ETHEREUM, "^0xab", False)
    # case-sensitive letters over-approximate (host regex filters casing)
    assert match_intervals(AddressFormat.ETHEREUM, "^0xAb", False) is not None


def test_pattern_method_route():
    assert Pattern("^1Cat").match_intervals(AddressFormat.P2PKH)
    assert Pattern("^1C+at").match_intervals(AddressFormat.P2PKH) is None


def test_interval_words_roundtrip():
    from vgen_tpu.ops.pipeline import intervals_to_words

    ivs = match_intervals(AddressFormat.P2PKH, "^1C", False)
    lo, hi = intervals_to_words(ivs)
    assert lo.shape == (8, 5) and hi.shape == (8, 5)
    for j, (l, h) in enumerate(ivs):
        assert int.from_bytes(lo[j].astype(">u4").tobytes(), "big") == l
        assert int.from_bytes(hi[j].astype(">u4").tobytes(), "big") == h
    # padding rows are empty (lo > hi)
    for j in range(len(ivs), 8):
        lv = int.from_bytes(lo[j].astype(">u4").tobytes(), "big")
        hv = int.from_bytes(hi[j].astype(">u4").tobytes(), "big")
        assert lv > hv


def test_case_insensitive_base58_intervals_sound():
    """-i on a Base58 prefix compiles to the union of case-variant
    intervals: every h whose address matches the pattern (case-folded)
    must fall inside, and interval membership must imply a case-variant
    prefix match (exact, up to checksum widening)."""
    ivs = match_intervals(AddressFormat.P2PKH, "^1ca", True)
    assert ivs is not None and len(ivs) <= 8
    pat = Pattern("^1ca", case_insensitive=True)
    rng = random.Random(99)
    n_in = 0
    for _ in range(4000):
        h = rng.getrandbits(160)
        addr = _p2pkh(h)
        inside = any(lo <= h <= hi for lo, hi in ivs)
        if pat.matches(addr):
            assert inside, f"false negative for {addr}"
            n_in += 1
        if inside:
            assert addr.lower().startswith("1ca")
    # some case variant must actually occur in the sample
    assert n_in > 0


def test_case_insensitive_base58_interval_matches_dfa_sets():
    """The -i interval path and the -i DFA must accept identical address
    sets for a short prefix (up to the documented checksum widening of the
    interval, which only ever ADDS candidates)."""
    ivs = match_intervals(AddressFormat.P2PKH, "^1ab", True)
    assert ivs is not None
    pat = Pattern("^1ab", case_insensitive=True)
    dev = pat.device_dfa(AddressFormat.P2PKH)
    from vgen_tpu.crypto.encode import BASE58_ALPHABET

    rng = random.Random(7)
    checked_matching = 0
    for _ in range(2000):
        h = rng.getrandbits(160)
        addr = _p2pkh(h)
        syms = [BASE58_ALPHABET.index(c) for c in addr]
        dfa_hit = dev.run(syms + [dev.eos_symbol])
        iv_hit = any(lo <= h <= hi for lo, hi in ivs)
        assert dfa_hit == pat.matches(addr)
        if dfa_hit:
            assert iv_hit  # interval is a superset of the DFA accept set
            checked_matching += 1
    assert checked_matching > 0


def test_case_insensitive_base58_too_many_letters_falls_back():
    # 5 alphabetic chars -> 32 case variants: beyond the slot budget
    assert match_intervals(AddressFormat.P2PKH, "^1abcde", True) is None
    # case-sensitive long literals still compile
    assert match_intervals(AddressFormat.P2PKH, "^1abcde", False) is not None


def test_case_insensitive_invalid_letter_variants_drop():
    # 'l' is not base58 but 'L' is: the -i expansion keeps the L variant
    ivs = match_intervals(AddressFormat.P2PKH, "^1l", True)
    assert ivs  # non-empty: '1L...' addresses exist
    rng = random.Random(3)
    pat = Pattern("^1l", case_insensitive=True)
    for _ in range(500):
        h = rng.getrandbits(160)
        addr = _p2pkh(h)
        if pat.matches(addr):
            assert any(lo <= h <= hi for lo, hi in ivs)


def test_prefilter_intervals_prefix_superset():
    """prefilter_intervals must cover every address matching the FULL
    pattern (superset), with probability matching the prefix width."""
    from vgen_tpu.pattern.intervals import prefilter_intervals

    pf = prefilter_intervals(AddressFormat.P2PKH, "^1C[ab]x.*z", False)
    assert pf is not None
    ivs, p = pf
    assert 0 < p < 1e-4  # ~2.5 * 2/58^3 (leading "1" is the zero-byte marker)
    pat = Pattern("^1C[ab]x.*z")
    rng = random.Random(11)
    hits = 0
    for _ in range(3000):
        h = rng.getrandbits(160)
        addr = _p2pkh(h)
        if pat.matches(addr):
            assert any(lo <= h <= hi for lo, hi in ivs)
            hits += 1
        # membership implies the PREFIX matches
        if any(lo <= h <= hi for lo, hi in ivs):
            assert addr.startswith(("1Ca", "1Cb"))


def test_prefilter_intervals_unanchored_none():
    from vgen_tpu.pattern.intervals import prefilter_intervals

    assert prefilter_intervals(AddressFormat.P2PKH, "Cat", False) is None
    # quantifier immediately after ^: no usable literal prefix
    assert prefilter_intervals(AddressFormat.P2PKH, "^1*", False) is None


def test_prefilter_intervals_shrinks_to_feasible_prefix():
    """A wide class position stops the prefix but the literal head still
    compiles."""
    from vgen_tpu.pattern.intervals import prefilter_intervals

    pf = prefilter_intervals(AddressFormat.P2PKH, "^1Cat[a-zA-Z0-9]{4}Q",
                             False)
    assert pf is not None
    ivs, p = pf
    assert p < 1e-4  # at least the ^1Cat prefix
