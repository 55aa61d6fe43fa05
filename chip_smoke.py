"""Smoke test of the vanity scan on one gpu, through the entry points a user
calls, at the CLI's default width (524,288 keys per window).

    python chip_smoke.py             # one card
    python chip_smoke.py --chips 4   # the four-card mesh path only

Phases (one card):
  1. device: the card's name and power limit, the JAX devices, the compile
     cache directory, whether the native re-derivation library loaded.
  2. oracle: for 6 formats x {interval path, DFA path}, one dispatch's
     device match masks (8 windows) against the host's independent
     re-derivation (vgen_tpu.scan.oracle), exact, over every index reported
     in any window and the first 65,536 keys of the first and last window.
  3. end to end through the CLI (run_from_args): `generate -c 2` for each
     format, every printed key re-derived by the pure-Python oracle; and a
     puzzle `range` with a checkpoint, which must print the published key.
  4. peak device memory and smoke scan rates (not a benchmark).

With --chips 4 it runs only the mesh: the puzzle range over four cards
(same key, operations equal to the range size) and one random interval
`generate`, beside the same range on one card, with the rate ratio.

Exits non-zero at the first failure; the last stdout line is the JSON
result, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

BATCH = 524_288

# phase 3: one anchored prefix per format with estimated difficulty
# (`estimate`) of at least 2^27 keys -- except P2TR: bech32 steps by 2^5 per
# character, so 2^27 means 2^30, and two matches at the XLA ladder's rate
# (PERF.md) would take most of an hour; P2TR uses 2^25.
GENERATE = (
    ("p2pkh", "^1Abcde"),
    ("p2pkh-uncompressed", "^1Abcde"),
    ("p2sh-p2wpkh", "^3Abcde"),
    ("p2wpkh", "^bc1qacdefg"),
    ("p2tr", "^bc1pacdef"),
    ("ethereum", "^0x1234567"),
)
MIN_DIFFICULTY = {"p2tr": 1 << 25}
PUZZLE = 30  # solved b1000 puzzle: P2PKH, key 0x3D94CD64
RANGE_BEFORE = 1 << 28  # keys scanned before the published key
RANGE_AFTER = 1 << 20
MESH_RANGE_BEFORE = 1 << 29  # below the key, so the range starts above 0
DFA_RATE_PATTERN = "BenchNeverMatch$"


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def phase_device(n_chips: int):
    import jax

    from vgen_tpu import compile_cache, native

    devices = jax.devices()
    require(devices[0].platform == "gpu",
            f"phase 1: JAX sees no gpu (devices: {devices}); this smoke "
            "test needs one")
    require(len(devices) >= n_chips,
            f"phase 1: {n_chips} gpus requested, JAX sees {len(devices)}")
    log(f"[1] card: {card_line()}")
    log(f"[1] jax {jax.__version__}: {devices}")
    log(f"[1] compile cache: {compile_cache.enable()}")
    log(f"[1] native re-derivation library loaded: {native.available()}"
        + ("" if native.available() else f" ({native.build_error()})"))
    return devices


def warm_all(pool: ThreadPoolExecutor):
    """Compile every scan step the phases use, concurrently, ahead of time
    (XLA compiles outside the interpreter lock; an AOT compile also serves
    later calls of the same jitted step): the 12 oracle cases, whose steps
    `generate` and the phase-4 rates reuse, and the puzzle range's step.
    Nothing runs on the card meanwhile.  Returns the oracle runner, the
    window base, and seconds per compile."""
    import secrets

    from vgen_tpu.crypto import secp256k1 as ec
    from vgen_tpu.crypto.address import AddressFormat
    from vgen_tpu.pattern import Pattern
    from vgen_tpu.scan import oracle
    from vgen_tpu.scan.scanner import CHAIN_LEN

    runner = oracle.WindowRunner(BATCH, CHAIN_LEN)
    runner.extras(AddressFormat.P2TR)  # build once, before threads
    base = 2 + secrets.randbelow(ec.N - 2 * BATCH)
    _, res = _puzzle()
    cases = [(fmt, Pattern(pat), False) for fmt, _, pat in oracle.CASES]
    cases.append((AddressFormat.P2PKH,
                  Pattern(f"^{re.escape(res.address)}$"), True))

    def compile_step(case):
        fmt, pattern, is_range = case
        t0 = time.perf_counter()
        _, step, args = runner.prepare(fmt, pattern, base, is_range)
        step.lower(*args).compile()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    secs = list(pool.map(compile_step, cases))
    log(f"[w] compiled {len(cases)} scan steps concurrently in "
        f"{time.perf_counter() - t0:.1f}s (the puzzle range step: "
        f"{secs[-1]:.1f}s)")
    return runner, base, secs


def phase_oracle(runner, base: int, warm_s) -> None:
    from vgen_tpu.scan import oracle

    bad = []
    for (fmt, path, pat), w in zip(oracle.CASES, warm_s):
        res = oracle.check_window(runner, fmt, pat, base, 65_536)
        log(f"[2] compile {w:6.1f}s | {res.line()}")
        if not res.ok:
            log(f"[2]   first mismatches (index, device, host): "
                f"{res.mismatches[:8]}")
            bad.append((fmt.value, path))
        require(res.n_host > 0, f"phase 2: {fmt.value} {path} had no "
                "matches to compare; pick a denser pattern")
    require(not bad, f"phase 2: device/oracle mismatches in {bad}")


def _read_jsonl(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _verify_printed(fmt_s: str, pattern: str, rows) -> None:
    from vgen_tpu.crypto.address import AddressFormat, AddressGenerator
    from vgen_tpu.pattern import Pattern

    gen = AddressGenerator(AddressFormat.from_str(fmt_s))
    pat = Pattern(pattern)
    for r in rows:
        ga = gen.generate(bytes.fromhex(r["private_key_hex"]))
        require(ga is not None and ga.address == r["address"]
                and ga.wif == r["wif"],
                f"phase 3: {fmt_s} key {r['private_key_hex']} re-derives to "
                f"{ga and ga.address}, printed {r['address']}")
        require(pat.matches(r["address"]),
                f"phase 3: {r['address']} does not match {pattern}")


def _puzzle():
    from vgen_tpu import provider

    key = provider._B1000_SOLVED_KEYS[PUZZLE]
    return key, provider.resolve(f"boha:b1000:{PUZZLE}")


def phase_cli(tmp: str) -> None:
    from vgen_tpu.cli import run_from_args
    from vgen_tpu.pattern import Pattern
    from vgen_tpu.crypto.address import AddressFormat

    key, res = _puzzle()
    lo, hi = key - RANGE_BEFORE, key + RANGE_AFTER
    for fmt_s, pat in GENERATE:
        d = Pattern(pat).estimate_difficulty(AddressFormat.from_str(fmt_s))
        want = MIN_DIFFICULTY.get(fmt_s, 1 << 27)
        require(d >= want, f"phase 3: {pat} difficulty {d} < {want}")

    for fmt_s, pat in GENERATE:
        out = os.path.join(tmp, f"gen-{fmt_s}.jsonl")
        t0 = time.perf_counter()
        rc = run_from_args(["generate", "-p", pat, "-f", fmt_s,
                            "--backend", "gpu", "--no-tui", "-o", "jsonl",
                            "-c", "2", "-q", "--file", out])
        require(rc == 0, f"phase 3: generate {fmt_s} exited {rc}")
        rows = _read_jsonl(out)
        require(len(rows) == 2, f"phase 3: generate {fmt_s} printed "
                f"{len(rows)} keys, expected 2")
        _verify_printed(fmt_s, pat, rows)
        log(f"[3] generate {fmt_s:18} {pat!r:14} 2 keys verified in "
            f"{time.perf_counter() - t0:6.1f}s "
            f"({rows[0]['operations']} ops, {rows[0]['rate']:.4g} ops/s)")

    out = os.path.join(tmp, "range.jsonl")
    t0 = time.perf_counter()
    rc = run_from_args(["range", "-p", f"boha:b1000:{PUZZLE}",
                        "--range", f"{lo:x}:{hi:x}", "--backend", "gpu",
                        "--no-tui", "-o", "jsonl", "--checkpoint",
                        os.path.join(tmp, "range.ckpt"), "--file", out])
    require(rc == 0, f"phase 3: range exited {rc}")
    rows = _read_jsonl(out)
    require([int(r["private_key_hex"], 16) for r in rows] == [key],
            f"phase 3: range printed {rows}, expected key {key:#x}")
    log(f"[3] range puzzle {PUZZLE} [{lo:#x}, {hi:#x}]: key {key:#x} found "
        f"in {time.perf_counter() - t0:.1f}s ({rows[0]['operations']} ops)")


def _steady_rate(fmt_s: str, pattern: str) -> float:
    from vgen_tpu.crypto.address import AddressFormat
    from vgen_tpu.scan.scanner import benchmark_device

    stats = benchmark_device(AddressFormat.from_str(fmt_s), pattern,
                             batch_size=BATCH, min_seconds=5.0)
    return stats["keys_per_sec"]


def phase_rates(card: str) -> None:
    import jax

    for label, pat in (("interval+GLV", GENERATE[0][1]),
                       ("DFA+GLV", DFA_RATE_PATTERN)):
        rate = _steady_rate("p2pkh", pat)
        log(f"[4] smoke rate, not a benchmark: P2PKH {label} {pat!r}: "
            f"{rate:.6g} keys/s (GLV variants counted) on {card}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[4] peak_bytes_in_use: {stats.get('peak_bytes_in_use')} "
        f"(bytes_limit {stats.get('bytes_limit')})")


def phase_mesh(pool: ThreadPoolExecutor, n_chips: int) -> None:
    import jax

    from vgen_tpu.crypto.address import AddressFormat, AddressGenerator
    from vgen_tpu.parallel.mesh import MeshScanner, make_mesh
    from vgen_tpu.pattern import Pattern
    from vgen_tpu.scan.scanner import DeviceScanner, ScanConfig

    key, res = _puzzle()
    lo, hi = key - MESH_RANGE_BEFORE, key + RANGE_AFTER
    require(lo >= 2, f"mesh phase: range start {lo} must be at least 2")
    pat = Pattern(f"^{re.escape(res.address)}$")
    mesh = MeshScanner(AddressFormat.P2PKH, BATCH,
                       mesh=make_mesh(jax.devices()[:n_chips]))
    single = DeviceScanner(AddressFormat.P2PKH, BATCH)
    gen_pat = Pattern(GENERATE[0][1])
    mesh_gen = MeshScanner(AddressFormat.P2PKH, BATCH, mesh=mesh.mesh)

    def cfg(start, end, count):
        return ScanConfig(format=AddressFormat.P2PKH, count=count,
                          start=start, end=end, device_batch_size=BATCH)

    # compile the three steps concurrently on short scans, each of which
    # must dispatch (an empty range would leave the compile to the timed run)
    t0 = time.perf_counter()
    for j in [pool.submit(mesh.scan, pat, 0, lo, lo + 1),
              pool.submit(single.scan, pat, cfg(lo, lo + 1, 0)),
              pool.submit(mesh_gen.scan, gen_pat, 1, None, None, None, None,
                          1)]:
        require(j.result().operations > 0,
                "mesh phase: a warm-up scan dispatched nothing")
    log(f"[m] compiled mesh and single-card steps in "
        f"{time.perf_counter() - t0:.1f}s")

    runs = {}
    for name, fn in (
        ("mesh", lambda: mesh.scan(pat, count=0, start=lo, end=hi)),
        ("single", lambda: single.scan(pat, cfg(lo, hi, 0))),
    ):
        t0 = time.perf_counter()
        r = fn()
        dt = time.perf_counter() - t0
        runs[name] = (r, dt)
        found = [int(m.hex, 16) for m in r.matches]
        log(f"[m] range on {name}: keys {[hex(k) for k in found]}, "
            f"{r.operations} ops in {dt:.2f}s = {r.operations / dt:.6g} "
            "keys/s")
        require(found == [key], f"mesh phase: {name} range found {found}")
        require(r.operations == hi - lo + 1,
                f"mesh phase: {name} range ops {r.operations} != "
                f"{hi - lo + 1}")
    (rm, tm), (rs, ts) = runs["mesh"], runs["single"]
    log(f"[m] rate ratio {n_chips} cards / 1 card: "
        f"{(rm.operations / tm) / (rs.operations / ts):.4f}")

    t0 = time.perf_counter()
    r = mesh_gen.scan(gen_pat, count=1)
    gen = AddressGenerator(AddressFormat.P2PKH)
    require(len(r.matches) == 1, "mesh phase: generate found nothing")
    for m in r.matches:
        ga = gen.generate(bytes.fromhex(m.hex))
        require(ga.address == m.address and gen_pat.matches(m.address),
                f"mesh phase: generate printed {m.address} for {m.hex}")
    log(f"[m] generate {GENERATE[0][1]!r} over {n_chips} cards: "
        f"{r.matches[0].address} verified ({r.operations} ops in "
        f"{time.perf_counter() - t0:.1f}s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    t_start = time.perf_counter()
    devices = phase_device(args.chips)
    card = card_line()
    with ThreadPoolExecutor(max_workers=16) as pool, \
            tempfile.TemporaryDirectory() as tmp:
        if args.chips == 1:
            phase_oracle(*warm_all(pool))
            phase_cli(tmp)
            phase_rates(card)
        else:
            phase_mesh(pool, args.chips)
    log(card)  # as nvidia-smi prints it: name, power limit
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
