"""Command-line interface: generate / estimate / range / verify / list-devices.

Behavioral parity with the reference CLI (lib.rs:35-211 clap definitions and
the run() dispatch lib.rs:281-560), adapted for JAX devices:
  * --no-gpu is kept as an alias of --no-device (CPU fallback)
  * --gpu-batch-size is an alias of --device-batch-size
  * list-gpus -> list-devices (JAX devices instead of wgpu adapters)
  * Ethereum runs ON device here (the reference falls back to CPU,
    lib.rs:316-319)
"""

from __future__ import annotations

import argparse
import signal
import sys
import time
from typing import List, Optional, Tuple

from vgen_tpu.crypto.address import AddressFormat, derive_all, parse_private_key
from vgen_tpu.output import (
    VanityResult,
    format_duration,
    format_with_commas,
    write_results,
)
from vgen_tpu.pattern import Pattern, RegexError
from vgen_tpu import provider as provider_mod


FORMAT_CHOICES = ["p2pkh", "p2pkh-uncompressed", "p2wpkh", "p2sh-p2wpkh",
                  "p2tr", "ethereum"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vgen-tpu",
        description="Bitcoin/Ethereum vanity address generator with regex "
        "pattern matching on a JAX device (GPU)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def add_common_search(sp, with_pattern_required=True):
        sp.add_argument(
            "-p", "--pattern",
            required=with_pattern_required,
            help="Regex pattern (e.g. '^1Cat', '^bc1q.*dead$') or provider "
            "reference (e.g. 'boha:b1000:66')",
        )
        sp.add_argument(
            "-l", "--prefix-length", type=int, default=None,
            help="For provider patterns: match on first N address chars",
        )
        sp.add_argument(
            "-f", "--format", default="p2pkh",
            choices=FORMAT_CHOICES,
        )
        sp.add_argument("-t", "--threads", type=int, default=None,
                        help="CPU threads for the fallback scanner")
        sp.add_argument("--no-device", "--no-gpu", dest="no_device",
                        action="store_true",
                        help="Disable device acceleration (native CPU "
                        "scanner)")
        sp.add_argument("--device-batch-size", "--gpu-batch-size",
                        dest="device_batch_size", type=int, default=None,
                        help="Keys per device dispatch (default 524288 "
                        "single-device, 262144 per mesh device)")
        sp.add_argument("--backend", default="auto",
                        choices=["auto", "gpu", "cpu"],
                        help="Device backend: auto uses the gpu when JAX "
                        "sees one, else the native CPU scanner; gpu "
                        "requires it; cpu runs the JAX pipeline on the "
                        "CPU backend")
        sp.add_argument("--no-tui", action="store_true",
                        help="Disable the terminal UI")
        sp.add_argument("-o", "--output", default="text",
                        choices=["text", "json", "jsonl", "csv", "minimal"])
        sp.add_argument("--file", default=None,
                        help="Write output to file instead of stdout")
        sp.add_argument("--repeat", type=int, default=1,
                        help="Repeat the search N times (perf testing)")
        sp.add_argument("--profile", default=None, metavar="DIR",
                        help="Capture a JAX profiler trace of the scan into "
                        "DIR (view with TensorBoard / xprof)")

    g = sub.add_parser("generate", help="Generate vanity address matching a pattern")
    add_common_search(g)
    g.add_argument("-i", "--ignore-case", action="store_true",
                   help="Case insensitive matching (P2PKH only)")
    g.add_argument("--cpu-batch-size", type=int, default=10000)
    g.add_argument("--tui", action="store_true",
                   help="(deprecated; TUI is default in terminals)")
    g.add_argument("-c", "--count", type=int, default=1,
                   help="Stop after finding N matches")
    g.add_argument("-q", "--quiet", action="store_true")

    e = sub.add_parser("estimate", help="Estimate difficulty of a pattern (dry run)")
    e.add_argument("-p", "--pattern", required=True)
    e.add_argument("-l", "--prefix-length", type=int, default=None)
    e.add_argument("-f", "--format", default="p2pkh", choices=FORMAT_CHOICES)
    e.add_argument("-i", "--ignore-case", action="store_true")

    r = sub.add_parser("range", help="Scan a specific key range (Bitcoin Puzzles)")
    add_common_search(r, with_pattern_required=False)
    r.add_argument("-r", "--range", dest="range_", default=None,
                   help="START:END hex keys (e.g. 2000:3FFF)")
    r.add_argument("--puzzle", type=int, default=None,
                   help="Puzzle number (sets range to [2^(n-1), 2^n-1])")
    r.add_argument("-c", "--count", type=int, default=1,
                   help="Stop after N matches (0 = scan entire range)")
    r.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="Persist scan position to FILE and resume from it "
                   "(survives interruption; not in the reference)")

    v = sub.add_parser("verify", help="Verify a private key produces expected address")
    v.add_argument("-k", "--key", required=True, help="Private key (WIF or hex)")
    v.add_argument("-a", "--address", default=None, help="Expected address")

    ld = sub.add_parser("list-devices", help="List available accelerator devices")
    ld.add_argument("--json", action="store_true")
    # keep the reference's name as an alias
    lg = sub.add_parser("list-gpus", help=argparse.SUPPRESS)
    lg.add_argument("--json", action="store_true")

    return p


def resolve_pattern_and_format(
    pattern: str, prefix_length: Optional[int], default_format: AddressFormat
) -> Tuple[str, AddressFormat]:
    """lib.rs:563-590 parity."""
    res = provider_mod.resolve(pattern)
    if res is not None:
        if prefix_length is not None:
            if prefix_length == 0:
                raise SystemExit(
                    "error: --prefix-length must be at least 1 for provider patterns"
                )
            resolved = provider_mod.build_pattern(res, prefix_length)
        else:
            resolved = provider_mod.build_exact_pattern(res)
        print(
            f"Provider: {pattern} → {res.address} → pattern '{resolved}'",
            file=sys.stderr,
        )
        return resolved, res.format
    if prefix_length is not None:
        print("Warning: --prefix-length is ignored for regex patterns",
              file=sys.stderr)
    return pattern, default_format


def resolve_range_params(
    pattern: str,
    prefix_length: Optional[int],
    default_format: AddressFormat,
    range_str: Optional[str],
    puzzle: Optional[int],
) -> Tuple[int, int, str, AddressFormat]:
    """lib.rs:592-663 parity."""
    res = provider_mod.resolve(pattern)
    if res is not None:
        if prefix_length is not None:
            if prefix_length == 0:
                raise SystemExit(
                    "error: --prefix-length must be at least 1 for provider patterns"
                )
            resolved = provider_mod.build_pattern(res, prefix_length)
        else:
            resolved = provider_mod.build_exact_pattern(res)
        print(f"Provider: {pattern} → {res.address}", file=sys.stderr)
        if range_str is not None or puzzle is not None:
            start, end = parse_explicit_range(range_str, puzzle)
        elif res.key_range is not None:
            start, end = res.key_range
        else:
            raise SystemExit(
                f"error: provider '{pattern}' has no key range; use --range or --puzzle"
            )
        return start, end, resolved, res.format
    start, end = parse_explicit_range(range_str, puzzle)
    return start, end, pattern, default_format


def parse_explicit_range(
    range_str: Optional[str], puzzle: Optional[int]
) -> Tuple[int, int]:
    if puzzle is not None:
        if not 1 <= puzzle <= 160:
            raise SystemExit("error: puzzle number must be between 1 and 160")
        return 1 << (puzzle - 1), (1 << puzzle) - 1
    if range_str is not None:
        parts = range_str.split(":")
        if len(parts) != 2:
            raise SystemExit("error: range must be in format START:END")
        try:
            return int(parts[0], 16), int(parts[1], 16)
        except ValueError:
            raise SystemExit("error: invalid hex in range")
    raise SystemExit(
        "error: either --range, --puzzle, or a provider pattern with a key "
        "range must be specified"
    )


def resolve_use_device(backend: str, no_device: bool) -> bool:
    """Decide whether to scan on a JAX device.

    gpu: required -- exit 2 when JAX sees no gpu.  cpu: the JAX pipeline on
    the CPU backend (--no-device selects the native C++ scanner instead).
    auto: the gpu when JAX sees one, else the native CPU scanner, which is
    the reference's documented behaviour without a GPU (lib.rs:708-747);
    that choice is said in one stderr line.
    """
    if no_device:
        return False
    import jax

    if backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
        return True
    # multi-host bootstrap must precede the first backend touch
    from vgen_tpu.parallel import distributed

    distributed.initialize()
    devices = jax.devices()
    if devices[0].platform == "gpu":
        return True
    if backend == "gpu":
        print(f"error: --backend gpu requested but JAX sees no gpu "
              f"(devices: {devices})", file=sys.stderr)
        raise SystemExit(2)
    print(f"No gpu visible to JAX ({devices[0].platform} only); using the "
          "native CPU scanner.", file=sys.stderr)
    return False


class _TwoStageInterrupt:
    """Ctrl+C: first press requests stop, second force-exits (lib.rs:1088-1097)."""

    def __init__(self, stop_flag):
        self.stop = stop_flag
        self._prev = None

    def __enter__(self):
        def handler(signum, frame):
            if self.stop.is_set():
                sys.exit(1)
            print("\nStopping... (press Ctrl+C again to force)", file=sys.stderr)
            self.stop.set()

        try:
            self._prev = signal.signal(signal.SIGINT, handler)
        except ValueError:  # not main thread (tests)
            self._prev = None
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            signal.signal(signal.SIGINT, self._prev)


def run_search(
    pattern_str: str,
    ignore_case: bool,
    fmt: AddressFormat,
    count: int,
    use_device: bool,
    device_batch_size: Optional[int],
    cpu_batch_size: Optional[int],
    threads: Optional[int],
    start: Optional[int],
    end: Optional[int],
    use_tui: bool,
    quiet: bool,
    output: str,
    file: Optional[str],
    repeat: int,
    checkpoint_path: Optional[str] = None,
    profile: Optional[str] = None,
) -> int:
    from vgen_tpu.scan import scanner as sc

    try:
        pat = Pattern(pattern_str, ignore_case)
    except RegexError as e:
        print(f"error: failed to compile pattern: {e}", file=sys.stderr)
        return 2

    ckpt_mgr = None
    if checkpoint_path and start is not None:
        from vgen_tpu.crypto.secp256k1 import N as _EC_N
        from vgen_tpu.scan.checkpoint import CheckpointManager

        ckpt_mgr = CheckpointManager(
            checkpoint_path,
            pattern=pattern_str,
            fmt=fmt.value,
            start=start,
            end=end if end is not None else _EC_N - 1,
        )
        state = ckpt_mgr.load()
        if state is not None and not quiet:
            print(
                f"Resuming from checkpoint: next key "
                f"{hex(state['next_key'])}, "
                f"{format_with_commas(state['operations'])} ops, "
                f"{len(state['match_keys'])} match(es)",
                file=sys.stderr,
            )

    invalid = pat.validate_charset(fmt)
    if invalid:
        name = fmt.charset_name
        print(
            f"Warning: Pattern contains characters not valid in {name} "
            f"addresses: '{''.join(invalid)}'",
            file=sys.stderr,
        )
        print(
            f"  {name} alphabet excludes these characters - pattern will "
            "NEVER match!",
            file=sys.stderr,
        )
        if name == "Base58":
            print(
                "  Base58 excludes: 0 (zero), O (uppercase o), I (uppercase i),"
                " l (lowercase L)",
                file=sys.stderr,
            )

    config = sc.ScanConfig(
        format=fmt,
        count=count if count != 0 else 0,
        threads=threads,
        device_batch_size=device_batch_size,
        cpu_batch_size=cpu_batch_size,
        start=start,
        end=end,
        use_device=use_device,
        checkpoint=ckpt_mgr,
    )

    stop = sc.StopFlag()
    repeat = max(1, repeat)

    if use_tui:
        try:
            from vgen_tpu.tui import run_tui

            result = run_tui(pat, config, stop)
        except Exception as e:  # TUI failure -> console fallback (lib.rs:760-763)
            print(f"TUI failed ({e}); falling back to console.", file=sys.stderr)
            use_tui = False
            result = None
        if use_tui and result is not None:
            # parity: the reference always writes results through the output
            # writers after the TUI's alternate screen closes (lib.rs:766+)
            results = _to_vanity_results(result, pattern_str, fmt)
            _emit(results, output, file, quiet, result)
            return 0

    t_total = time.time()
    all_matches = []
    total_ops = 0
    prof_cm = None
    if profile:
        # aux tracing subsystem (SURVEY §5): the reference has nothing beyond
        # its live-rate display; here a full device trace lands in `profile`
        # for TensorBoard/xprof
        import jax

        prof_cm = jax.profiler.trace(profile)
        prof_cm.__enter__()
    try:
        with _TwoStageInterrupt(stop):
            last_print = [0.0]

            def progress(ops):
                if quiet:
                    return
                now = time.time()
                if now - last_print[0] > 0.5:
                    last_print[0] = now
                    elapsed = now - t_total
                    rate = (total_ops + ops) / elapsed if elapsed > 0 else 0.0
                    print(
                        f"\r[{format_duration(elapsed)}] checked "
                        f"{format_with_commas(total_ops + ops)} keys "
                        f"({rate:,.0f}/s)   ",
                        end="",
                        file=sys.stderr,
                    )

            for _ in range(repeat):
                res = sc.scan_with_progress(pat, config, progress, stop)
                total_ops += res.operations
                all_matches.extend(res.matches)
                if stop.is_set():
                    break
    finally:
        if prof_cm is not None:
            prof_cm.__exit__(None, None, None)
            if not quiet:
                print(f"\nProfiler trace written to {profile}",
                      file=sys.stderr)
    if not quiet:
        print("", file=sys.stderr)

    elapsed = time.time() - t_total

    class R:
        pass

    result = R()
    result.matches = all_matches
    result.operations = total_ops
    result.elapsed_secs = elapsed
    results = _to_vanity_results(result, pattern_str, fmt)
    _emit(results, output, file, quiet, result)
    return 0


def _to_vanity_results(result, pattern_str, fmt) -> List[VanityResult]:
    rate = result.operations / result.elapsed_secs if result.elapsed_secs > 0 else 0.0
    return [
        VanityResult(
            address=m.address,
            wif=m.wif,
            private_key_hex=m.hex,
            format=fmt.display_name,
            pattern=pattern_str,
            operations=result.operations,
            elapsed_secs=result.elapsed_secs,
            rate=rate,
        )
        for m in result.matches
    ]


def _emit(results, output, file, quiet, result):
    if file:
        with open(file, "w") as f:
            write_results(results, output, f, quiet)
        if results and not quiet:
            print(f"Wrote {len(results)} result(s) to {file}", file=sys.stderr)
    else:
        write_results(results, output, sys.stdout, quiet)
    if not results and not quiet:
        print(
            f"No match found after {format_with_commas(result.operations)} "
            f"operations ({format_duration(result.elapsed_secs)})",
            file=sys.stderr,
        )


def cmd_generate(args) -> int:
    fmt = AddressFormat.from_str(args.format)
    pattern_str, fmt = resolve_pattern_and_format(
        args.pattern, args.prefix_length, fmt
    )
    if args.tui:
        print(
            "Warning: --tui is deprecated. TUI is now enabled by default in "
            "interactive terminals.",
            file=sys.stderr,
        )
    if args.ignore_case and fmt in (AddressFormat.P2WPKH, AddressFormat.ETHEREUM):
        print(
            "Warning: Bech32/Ethereum addresses case sensitivity handling is "
            "specific. -i flag might be redundant.",
            file=sys.stderr,
        )
    use_tui = (not args.no_tui) and sys.stdout.isatty()
    use_device = resolve_use_device(args.backend, args.no_device)
    if use_tui and args.repeat > 1:
        print("error: TUI mode supports a single run; use --no-tui",
              file=sys.stderr)
        return 2
    return run_search(
        pattern_str, args.ignore_case, fmt, args.count, use_device,
        args.device_batch_size, args.cpu_batch_size, args.threads,
        None, None, use_tui, args.quiet, args.output, args.file, args.repeat,
        profile=args.profile,
    )


def cmd_estimate(args) -> int:
    from vgen_tpu.scan.scanner import benchmark

    fmt = AddressFormat.from_str(args.format)
    pattern_str, fmt = resolve_pattern_and_format(
        args.pattern, args.prefix_length, fmt
    )
    try:
        pat = Pattern(pattern_str, args.ignore_case)
    except RegexError as e:
        print(f"error: failed to compile pattern: {e}", file=sys.stderr)
        return 2
    difficulty = pat.estimate_difficulty(fmt)
    # 10,000-iteration calibration, matching the reference's runtime
    # self-benchmark (scanner.rs:333, lib.rs:362)
    rate = benchmark(fmt, 10_000)
    expected = difficulty / rate if rate > 0 else float("inf")
    print(f"Pattern: {pattern_str}")
    print(f"Format: {fmt.display_name}")
    print(f"Case insensitive: {str(args.ignore_case).lower()}")
    print()
    print(f"Estimated difficulty: 1 in {format_with_commas(difficulty)}")
    from vgen_tpu import native as _native

    rate_src = "native CPU scanner" if _native.available() else (
        "CPU single thread"
    )
    print(f"Benchmark rate: {rate:.0f} addr/sec ({rate_src})")
    print(f"Expected time: {format_duration(expected)} (CPU)")

    # Device calibration (reference lib.rs:347-373 only ever measured the
    # CPU; here a visible gpu runs ~2s of the REAL scan path for this
    # pattern/format -- interval fast path, GLV, or generic DFA, whichever
    # the pattern compiles to)
    if resolve_use_device("auto", no_device=False):
        import jax

        from vgen_tpu.scan.scanner import benchmark_device

        print("Calibrating on device (the first run compiles the scan "
              "step)...", file=sys.stderr)
        stats = benchmark_device(
            fmt, pattern_str=pattern_str, min_seconds=2.0,
            warmup_batches=1, ignore_case=args.ignore_case,
        )
        drate = stats["keys_per_sec"]
        dexpected = difficulty / drate if drate > 0 else float("inf")
        print(f"Device rate: {drate:,.0f} keys/sec "
              f"({jax.devices()[0].device_kind})")
        print(f"Expected time: {format_duration(dexpected)} (device)")
    else:
        print("Note: run estimate on a gpu host to calibrate the device "
              "scan rate.")
    return 0


def cmd_range(args) -> int:
    fmt = AddressFormat.from_str(args.format)
    pattern_str = args.pattern if args.pattern is not None else "."
    start, end, resolved, fmt = resolve_range_params(
        pattern_str, args.prefix_length, fmt, args.range_, args.puzzle
    )
    count = args.count  # 0 = scan entire range
    use_tui = (not args.no_tui) and sys.stdout.isatty()
    use_device = resolve_use_device(args.backend, args.no_device)
    return run_search(
        resolved, False, fmt, count, use_device, args.device_batch_size,
        None, args.threads, start, end, use_tui, False, args.output,
        args.file, args.repeat, checkpoint_path=args.checkpoint,
        profile=args.profile,
    )


def cmd_verify(args) -> int:
    """lib.rs:377-494 parity."""
    try:
        secret = parse_private_key(args.key)
    except (ValueError, Exception) as e:
        print(f"error: invalid key format (not WIF or hex): {e}", file=sys.stderr)
        return 2
    d = derive_all(secret)
    is_wif = not set(args.key.lower()).issubset(set("0123456789abcdefx"))
    print(f"Private key: {args.key if is_wif else d['wif']}")
    print(f"WIF (uncompr.):     {d['wif_uncompressed']}")
    print(f"Hex: {d['hex']}")
    print()
    print(f"P2PKH address:      {d['p2pkh']}")
    print(f"P2PKH (uncompr.):   {d['p2pkh_uncompressed']}")
    print(f"P2WPKH address:     {d['p2wpkh']}")
    print(f"P2SH-P2WPKH addr:  {d['p2sh_p2wpkh']}")
    print(f"P2TR address:       {d['p2tr']}")
    print(f"Ethereum address:   {d['ethereum']}")

    if args.address:
        expected = args.address
        # BIP173: bech32 allows all-lower or all-upper; normalize single-case
        is_bech32 = expected[:3].lower() == "bc1"
        alpha = [c for c in expected if c.isalpha()]
        single_case = all(c.islower() for c in alpha) or all(
            c.isupper() for c in alpha
        )
        normalized = expected.lower() if (is_bech32 and single_case) else expected

        candidates = [
            d["p2pkh"], d["p2pkh_uncompressed"], d["p2wpkh"],
            d["p2sh_p2wpkh"], d["p2tr"], d["ethereum"],
        ]
        is_raw_eth = len(normalized) == 40 and all(
            c in "0123456789abcdefABCDEF" for c in normalized
        )
        eth_normalized = "0x" + normalized if is_raw_eth else normalized

        if normalized in candidates:
            print("\nMATCH!")
        elif eth_normalized[:2].lower() == "0x" and d[
            "ethereum"
        ].lower() == eth_normalized.lower():
            print("\nMATCH! (Ethereum, case-insensitive)")
        else:
            print(f"\nMISMATCH! Expected: {expected}")
    return 0


def cmd_list_devices(args) -> int:
    import json as _json

    import jax

    devices = []
    try:
        for dev in jax.devices():
            info = {
                "id": dev.id,
                "platform": dev.platform,
                "kind": getattr(dev, "device_kind", str(dev)),
                "process": dev.process_index,
                # XLA:CPU enumerates as a device but is emulation (the
                # reference's software-rasterizer flag, gpu.rs:65-80)
                "software": dev.platform == "cpu",
            }
            try:
                stats = dev.memory_stats() or {}
                lim = stats.get("bytes_limit")
                use = stats.get("bytes_in_use")
                if lim is not None:
                    info["hbm_bytes_limit"] = lim
                if use is not None:
                    info["hbm_bytes_in_use"] = use
            except Exception:
                pass  # memory_stats unsupported on some backends
            devices.append(info)
    except Exception as e:
        print(f"error enumerating devices: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(_json.dumps(devices, indent=2))
        return 0
    print("Available devices:")
    if not devices:
        print("  (none)")
    for i, d in enumerate(devices):
        extra = " [software]" if d["software"] else ""
        mem = ""
        if "hbm_bytes_limit" in d:
            mem = f", {d['hbm_bytes_limit'] / 2**30:.1f} GiB HBM"
        print(f"  {i + 1}. {d['kind']} ({d['platform']}) - id {d['id']}"
              f"{mem}{extra}")
    return 0


def run_from_args(argv: List[str]) -> int:
    from vgen_tpu import compile_cache

    compile_cache.enable()
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "generate":
        return cmd_generate(args)
    if args.command == "estimate":
        return cmd_estimate(args)
    if args.command == "range":
        return cmd_range(args)
    if args.command == "verify":
        return cmd_verify(args)
    if args.command in ("list-devices", "list-gpus"):
        return cmd_list_devices(args)
    parser.error(f"unknown command {args.command}")  # pragma: no cover
    return 2


def main() -> None:  # pragma: no cover
    sys.exit(run_from_args(sys.argv[1:]))
