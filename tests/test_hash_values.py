"""What the scan step hashes and compares, per format, vs the host oracle.

interval_value_words (the non-GLV interval compare), glv_interval_mask (the
6-variant compare) and the symbol functions the DFA runs on, each against
hashlib / the pure-Python address encoders on random coordinates."""

import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest

from vgen_tpu.crypto import address as host_addr
from vgen_tpu.crypto import secp256k1 as ec
from vgen_tpu.crypto.address import AddressFormat as F
from vgen_tpu.crypto.hashes import keccak256
from vgen_tpu.crypto.hashes import ripemd160 as host_ripemd
from vgen_tpu.ops import pipeline, u256
from vgen_tpu.pattern.pattern import _DEVICE_ALPHABETS

rng = random.Random(41)
B = 16


def _coords():
    xs = [rng.randrange(ec.P) for _ in range(B)]
    ys = [rng.randrange(ec.P) for _ in range(B)]
    return xs, ys, jnp.asarray(u256.from_int(xs)), jnp.asarray(
        u256.from_int(ys))


def _pub33(x, y):
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def _pub65(x, y):
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def _h160(b):
    return host_ripemd(hashlib.sha256(b).digest())


def _host_value(fmt, x, y):
    """The bytes the interval path compares for point (x, y)."""
    if fmt in (F.P2PKH, F.P2WPKH):
        return _h160(_pub33(x, y))
    if fmt == F.P2PKH_UNCOMPRESSED:
        return _h160(_pub65(x, y))
    if fmt == F.P2SH_P2WPKH:
        return _h160(b"\x00\x14" + _h160(_pub33(x, y)))
    return keccak256(_pub65(x, y)[1:])[12:]


def _words(wlist):
    w = np.asarray(jnp.stack(wlist))
    return [b"".join(int(w[i, b]).to_bytes(4, "big")
                     for i in range(w.shape[0])) for b in range(w.shape[1])]


VALUE_FORMATS = [F.P2PKH, F.P2WPKH, F.P2SH_P2WPKH, F.P2PKH_UNCOMPRESSED,
                 F.ETHEREUM]


@pytest.mark.parametrize("fmt", VALUE_FORMATS, ids=lambda f: f.value)
def test_interval_value_words_vs_host(fmt):
    xs, ys, xl, yl = _coords()
    words, ok = pipeline.interval_value_words(fmt, xl, yl)
    assert ok is None
    assert _words(words) == [_host_value(fmt, x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize(
    "fmt", [F.P2PKH, F.P2SH_P2WPKH, F.P2PKH_UNCOMPRESSED, F.ETHEREUM],
    ids=lambda f: f.value)
def test_glv_interval_mask_vs_host(fmt):
    """Bit 2v+pi is set iff variant (BETA^v x, parity index pi) falls in an
    interval: pi is the sign of y for GLV_EXACT_Y formats and the
    compressed-prefix parity otherwise."""
    xs, ys, xl, yl = _coords()
    lo = np.zeros((2, 5), dtype=np.uint32)
    hi = np.full((2, 5), 0xFFFFFFFF, dtype=np.uint32)
    hi[0, 0] = 0x3FFFFFFF
    lo[1] = [0xC0000000, 0, 0, 0, 0]
    hi[1, 0] = 0xC0FFFFFF
    got = np.asarray(pipeline.glv_interval_mask(
        fmt, xl, yl, jnp.asarray(lo), jnp.asarray(hi)))
    exact_y = fmt in pipeline.GLV_EXACT_Y

    def hit(value):
        v = int.from_bytes(value, "big")
        return any(
            int.from_bytes(b"".join(int(w).to_bytes(4, "big") for w in lo[j]),
                           "big") <= v
            <= int.from_bytes(b"".join(int(w).to_bytes(4, "big")
                                       for w in hi[j]), "big")
            for j in range(2))

    want = []
    for x, y in zip(xs, ys):
        bits = 0
        for v, beta in enumerate((1, ec.BETA, ec.BETA2)):
            xv = x * beta % ec.P
            for pi in (0, 1):
                if exact_y:
                    yv = y if pi == 0 else (ec.P - y) % ec.P
                else:
                    yv = pi  # only the parity reaches the prefix byte
                bits |= int(hit(_host_value(fmt, xv, yv))) << (2 * v + pi)
        want.append(bits)
    assert list(got) == want
    assert any(want)


_HOST_ADDRESS = {
    F.P2PKH: lambda x, y: host_addr.p2pkh_address(_pub33(x, y)),
    F.P2PKH_UNCOMPRESSED: lambda x, y: host_addr.p2pkh_address(_pub65(x, y)),
    F.P2WPKH: lambda x, y: host_addr.p2wpkh_address(_pub33(x, y)),
    F.P2SH_P2WPKH: lambda x, y: host_addr.p2sh_p2wpkh_address(_pub33(x, y)),
    F.ETHEREUM: lambda x, y: host_addr.ethereum_address(_pub65(x, y)),
}


@pytest.mark.parametrize("fmt", list(_HOST_ADDRESS), ids=lambda f: f.value)
def test_symbols_vs_host_address(fmt):
    xs, ys, xl, yl = _coords()
    syms, length = pipeline._SYMBOLS[fmt](xl, yl)
    syms, length = np.asarray(syms), np.asarray(length)
    digits, prefix = _DEVICE_ALPHABETS[fmt]
    for b, (x, y) in enumerate(zip(xs, ys)):
        got = prefix + "".join(digits[s] for s in syms[:length[b], b])
        assert got == _HOST_ADDRESS[fmt](x, y)
