"""Scanner integration tests (device path on the CPU backend + the native
CPU scanner).

Mirrors the reference's scanner tests (scanner.rs:348-466): always-match
patterns, multiple matches, stop-flag honored under an impossible pattern,
range semantics, rate math.
"""

import threading
import time

import pytest

from vgen_tpu.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu.pattern import Pattern
from vgen_tpu.scan import route
from vgen_tpu.scan import scanner as sc

BATCH = 256


def config(**kw):
    kw.setdefault("device_batch_size", BATCH)
    return sc.ScanConfig(**kw)


def test_scan_finds_match():
    res = sc.scan_with_progress(Pattern("^1"), config(format=AddressFormat.P2PKH))
    assert len(res.matches) == 1
    assert res.matches[0].address.startswith("1")
    assert res.operations >= 1
    assert res.elapsed_secs > 0


def test_scan_finds_multiple():
    res = sc.scan_with_progress(
        Pattern("^1"), config(format=AddressFormat.P2PKH, count=3)
    )
    assert len(res.matches) == 3
    for m in res.matches:
        assert m.address.startswith("1")


def test_scan_p2wpkh():
    res = sc.scan_with_progress(Pattern("^bc1q"), config(format=AddressFormat.P2WPKH))
    assert len(res.matches) == 1
    assert res.matches[0].address.startswith("bc1q")


def test_scan_with_stop_flag():
    stop = sc.StopFlag()
    progress = []

    def cb(ops):
        progress.append(ops)
        if len(progress) >= 3:
            stop.set()

    res = sc.scan_with_progress(
        Pattern("^1ZZZZZZZZZZ"), config(format=AddressFormat.P2PKH), cb, stop
    )
    assert res.matches == []
    assert res.operations > 0


def test_range_scan_exact_address():
    key = 0xDEAD
    addr = AddressGenerator(AddressFormat.P2PKH).generate(key.to_bytes(32, "big")).address
    import re

    pat = Pattern(f"^{re.escape(addr)}$")
    res = sc.scan_with_progress(
        pat, config(format=AddressFormat.P2PKH, start=0xD000, end=0xE000)
    )
    assert len(res.matches) == 1
    assert res.matches[0].address == addr
    assert res.matches[0].hex == key.to_bytes(32, "big").hex()


def test_range_scan_exhausts_without_match():
    pat = Pattern("^1ZZZZZZZZZZZZ")
    res = sc.scan_with_progress(
        pat, config(format=AddressFormat.P2PKH, start=1000, end=1000 + 2 * BATCH)
    )
    assert res.matches == []
    assert res.operations == 2 * BATCH + 1


def test_range_scan_includes_key_one():
    # range [1, 300]: key 1 is the puzzle #1 key; base-0 edge handled on host
    addr1 = "1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH"
    import re

    pat = Pattern(f"^{re.escape(addr1)}$")
    res = sc.scan_with_progress(
        pat, config(format=AddressFormat.P2PKH, start=1, end=300)
    )
    assert len(res.matches) == 1
    assert res.matches[0].hex.endswith("01")


def test_cpu_fallback_scan():
    res = sc.scan_with_progress(
        Pattern("^1"),
        config(format=AddressFormat.P2PKH, use_device=False, cpu_batch_size=50),
    )
    assert len(res.matches) == 1
    assert res.matches[0].address.startswith("1")


def test_cpu_fallback_range():
    key = 0x123
    addr = AddressGenerator(AddressFormat.P2PKH).generate(key.to_bytes(32, "big")).address
    import re

    res = sc.scan_with_progress(
        Pattern(f"^{re.escape(addr)}$"),
        config(format=AddressFormat.P2PKH, use_device=False, start=0x100, end=0x200),
    )
    assert len(res.matches) == 1
    assert res.matches[0].hex == key.to_bytes(32, "big").hex()


def test_scan_result_rate():
    r = sc.ScanResult(matches=[], operations=1000, elapsed_secs=0.5)
    assert abs(r.rate() - 2000.0) < 0.01


def test_benchmark():
    assert sc.benchmark(AddressFormat.P2PKH, 20) > 0


def test_default_config():
    cfg = sc.ScanConfig()
    assert cfg.format == AddressFormat.P2PKH
    assert cfg.count == 1
    assert cfg.threads is None


def test_device_failure_propagates(monkeypatch):
    """A device error inside scan_with_progress reaches the caller: no
    silent rerun on the CPU scanner."""

    class Boom:
        def __init__(self, *a, **kw):
            raise RuntimeError("device lost")

    monkeypatch.setattr(sc, "DeviceScanner", Boom)
    monkeypatch.setattr(sc, "_scanner_cache", {})
    with pytest.raises(RuntimeError, match="device lost"):
        sc.scan_with_progress(
            Pattern("^1"),
            config(format=AddressFormat.P2PKH, use_device=True, count=1,
                   cpu_batch_size=50),
        )


def test_device_error_mid_scan_propagates(monkeypatch):
    """An error raised by the compiled step itself (not the scanner's
    construction) propagates too."""
    from vgen_tpu.ops import pipeline

    def broken(*a, **kw):
        raise RuntimeError("XLA execution failed")

    monkeypatch.setattr(pipeline, "packed_xla_scan_step",
                        lambda *a: broken)
    monkeypatch.setattr(sc, "_scanner_cache", {})
    with pytest.raises(RuntimeError, match="XLA execution failed"):
        sc.scan_with_progress(
            Pattern("^1Cat"),
            config(format=AddressFormat.P2PKH, use_device=True, count=1,
                   device_batch_size=BATCH, start=1000, end=5000),
        )


def test_range_scan_doubling_degenerate_key():
    """Key 2*base falls on the masked tx==bx doubling slot of its window
    (deterministic when base <= batch); the host must check it so no range
    key is skipped.  Window: start 0x100 -> base 0xFF -> key 0x1FE."""
    key = 0x1FE
    addr = AddressGenerator(AddressFormat.P2PKH).generate(
        key.to_bytes(32, "big")
    ).address
    import re

    pat = Pattern(f"^{re.escape(addr)}$")
    res = sc.scan_with_progress(
        pat, config(format=AddressFormat.P2PKH, start=0x100, end=0x1FF)
    )
    assert [m.hex for m in res.matches] == [key.to_bytes(32, "big").hex()]
    assert res.operations == 0x100  # every key in the range counted


def test_range_scan_reports_all_matches_beyond_topk():
    """Every P2PKH address starts with '1': a full window of matches
    overflows the TOP_K=16 packed index slots and must trigger the
    full-mask recovery (reference reports every match, gpu.rs:1030-1093)."""
    res = sc.scan_with_progress(
        Pattern("^1"),
        config(format=AddressFormat.P2PKH, start=1000, end=1299, count=0),
    )
    assert res.operations == 300
    keys = sorted(int(m.hex, 16) for m in res.matches)
    assert keys == list(range(1000, 1300))


def test_range_scan_dfa_path_beyond_topk():
    """Unanchored pattern (no interval compilation -> DFA path) with a full
    window of matches: full-mask recovery on the DFA tail."""
    res = sc.scan_with_progress(
        Pattern("1"),
        config(format=AddressFormat.P2PKH, start=500, end=500 + BATCH - 1,
               count=0),
    )
    keys = sorted(int(m.hex, 16) for m in res.matches)
    assert keys == list(range(500, 500 + BATCH))


def test_random_scan_beyond_topk():
    """Random scan where every key matches: the drain must surface more
    than TOP_K matches from a single window."""
    res = sc.scan_with_progress(
        Pattern("^1"), config(format=AddressFormat.P2PKH, count=40)
    )
    assert len(res.matches) == 40
    assert all(m.address.startswith("1") for m in res.matches)


def test_random_scan_recovers_window_for_large_count():
    """count exceeding what the TOP_K slots (x GLV variants) can deliver
    must trigger full-window recovery instead of burning extra windows:
    one 256-key window of an always-match pattern satisfies count=100
    (16 slots x 6 GLV variants = 96 < 100 forces the recovery dispatch)."""
    res = sc.scan_with_progress(
        Pattern("^1"), config(format=AddressFormat.P2PKH, count=100)
    )
    assert len(res.matches) == 100
    # ops == one GLV window (6 keys per position): recovery, not new windows
    assert res.operations == 6 * BATCH
    assert all(m.address.startswith("1") for m in res.matches)


def test_prefilter_hybrid_range_scan_finds_key():
    """A class pattern (no exact interval compilation) with a selective
    literal prefix must still find its key -- the scanner routes it down
    the interval path as a pre-filter and regex-checks survivors."""
    key = 0x54321
    addr = AddressGenerator(AddressFormat.P2PKH).generate(
        key.to_bytes(32, "big")
    ).address
    # e.g. addr '1ABCDE...' -> pattern '^1ABCD[Ex]' : class => DFA-nominal
    pat = Pattern(f"^{addr[:5]}[{addr[5]}x]")
    assert pat.match_intervals(AddressFormat.P2PKH) is None
    scanner = sc.DeviceScanner(AddressFormat.P2PKH, BATCH, chain_len=BATCH)
    cfg = config(format=AddressFormat.P2PKH, count=0, start=0x54000,
                 end=0x54FFF)
    assert route.plan_intervals(pat, cfg.format, BATCH, True) is not None
    res = scanner.scan(pat, cfg)
    assert key.to_bytes(32, "big").hex() in [m.hex for m in res.matches]
    assert res.operations == 0x1000
    # and every reported match satisfies the FULL pattern
    assert all(pat.matches(m.address) for m in res.matches)


def test_prefilter_gate_falls_back_for_weak_prefix():
    """'^1.at' has prefix '1' (p ~ 1): far beyond the survivor budget, so
    the planner must return None (pure DFA path)."""
    pat = Pattern("^1.at")
    assert route.plan_intervals(pat, AddressFormat.P2PKH, BATCH, False) is None
