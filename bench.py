"""Benchmark: P2PKH regex scan rate on the local gpu.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "keys/s", "vs_baseline": N/2e6}

Baseline: the reference's best-case GPU rate of 2M keys/s (README.md:176,
BASELINE.md).  Config mirrors BASELINE.json's headline: P2PKH prefix scan
"^1C" -- full keygen -> hash160 -> Base58Check -> regex pipeline per key.

Deadline-managed (VERDICT r3 item 1: the round-3 run timed out inside the
validation gate and produced NO number).  All work runs on a daemon worker
thread; the main thread enforces VGEN_BENCH_DEADLINE (seconds, default 780)
and ALWAYS emits the JSON line -- with the measured rate and
validated="partial:n/m" if validation was truncated, or value 0 plus an
error field if even the measurement did not finish.  SIGTERM triggers the
same early emit, so an external `timeout` still yields a parsable line.
Stage wall-times and the card's name and power limit go to stderr.  The
exit code is 0 only when the rate was measured on a gpu and every
validation case run passed.

Env knobs: VGEN_BENCH_BATCH (default 524288), VGEN_BENCH_SECONDS (default
10), VGEN_BENCH_PATTERN (default "^1C"), VGEN_BENCH_CHAIN (default 1024),
VGEN_BENCH_KSUB (default 16), VGEN_BENCH_VALIDATE (1 default: the P2PKH
cases of the oracle check / 0 / full: all 12 cases),
VGEN_BENCH_DEADLINE (default 780).
"""

import json
import os
import signal
import sys
import threading
import time


STATE = {
    "stage": "init",
    "value": 0.0,
    "validated": None,  # None (not attempted) / {"done", "total", "passed"}
    "error": None,
    "detail": "",
    "done": False,
}
EMITTED = threading.Event()


def emit():
    """Print the single JSON line (exactly once).

    Written straight to file descriptor 1, whatever sys.stdout is."""
    if EMITTED.is_set():
        return
    EMITTED.set()
    out = {
        "metric": "keys/sec/chip (P2PKH regex scan)",
        "value": STATE["value"],
        "unit": "keys/s",
        "vs_baseline": STATE["value"] / 2_000_000.0,
    }
    v = STATE["validated"]
    if v is not None:
        if v["done"] < v["total"]:
            out["validated"] = (
                f"partial:{v['done']}/{v['total']}"
                + ("" if v["passed"] else ":FAIL")
            )
        else:
            out["validated"] = v["passed"]
    err = STATE["error"]
    if err is None and STATE["value"] == 0:
        err = f"benchmark did not complete (stage={STATE['stage']})"
    if err is not None:
        out["error"] = err
    os.write(1, (json.dumps(out) + "\n").encode())
    if STATE["detail"]:
        print(STATE["detail"], file=sys.stderr)


def stage(name):
    STATE["stage"] = name
    STATE["t_stage"] = time.monotonic()
    print(f"# stage {name} ...", file=sys.stderr, flush=True)


def stage_done(name):
    dt = time.monotonic() - STATE.get("t_stage", time.monotonic())
    print(f"# stage {name}: {dt:.1f}s", file=sys.stderr, flush=True)


def worker(deadline: float):
    try:
        stage("import-jax")
        import jax

        from vgen_tpu import compile_cache

        compile_cache.enable()
        stage_done("import-jax")

        batch = int(os.environ.get("VGEN_BENCH_BATCH", 524_288))
        seconds = float(os.environ.get("VGEN_BENCH_SECONDS", 10))
        pattern = os.environ.get("VGEN_BENCH_PATTERN", "^1C")
        chain = int(os.environ.get("VGEN_BENCH_CHAIN", 1024))
        k_sub = int(os.environ.get("VGEN_BENCH_KSUB", 16))

        stage("device-probe")
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            raise RuntimeError(f"no gpu visible to JAX ({jax.devices()})")
        from chip_smoke import card_line

        print(f"# card: {card_line()}", file=sys.stderr, flush=True)
        stage_done("device-probe")
        print(f"# devices: {len(jax.devices())} x {dev.device_kind}",
              file=sys.stderr, flush=True)

        # MEASURE FIRST: a truncated run must still carry a rate.  The
        # scan warmup compiles the same step the product scan uses.
        stage("measure")
        from vgen_tpu.crypto.address import AddressFormat
        from vgen_tpu.scan.scanner import benchmark_device

        stats = benchmark_device(
            AddressFormat.P2PKH,
            pattern_str=pattern,
            batch_size=batch,
            min_seconds=seconds,
            chain_len=chain,
            k_sub=k_sub,
        )
        STATE["value"] = stats["keys_per_sec"]
        STATE["detail"] = (
            f"# device={dev.device_kind} batch={batch} "
            f"ops={stats['operations']} elapsed={stats['elapsed']:.2f}s"
        )
        stage_done("measure")

        # Correctness gate: the device's match masks against the host's
        # independent re-derivation (scan.oracle, chip_smoke phase 2)
        # BEFORE the rate is final -- a fast wrong step must not produce a
        # bench win.  Runs cases until the deadline margin.
        validate = os.environ.get("VGEN_BENCH_VALIDATE", "1")
        if validate != "0":
            stage("validate")
            from vgen_tpu.scan import oracle

            cases = [c for c in oracle.CASES
                     if validate == "full" or c[0] == AddressFormat.P2PKH]
            v = {"done": 0, "total": len(cases), "passed": True}
            STATE["validated"] = v
            runner = oracle.WindowRunner(batch, chain)
            for fmt, path, pat in cases:
                if time.monotonic() > deadline - 60.0:
                    break
                res = oracle.check_window(runner, fmt, pat, 0x5EED_0000_0001
                                          + 7 * batch, 65_536)
                print(f"# validate {res.line()}", file=sys.stderr,
                      flush=True)
                v["passed"] = v["passed"] and res.ok
                v["done"] += 1
            stage_done("validate")
    except Exception as e:  # pragma: no cover
        STATE["error"] = f"{type(e).__name__}: {e}"
    finally:
        STATE["done"] = True


def exit_code() -> int:
    v = STATE["validated"]
    ok = (STATE["error"] is None and STATE["value"] > 0
          and (v is None or v["passed"]))
    return 0 if ok else 1


def main():
    budget = float(os.environ.get("VGEN_BENCH_DEADLINE", "780"))
    deadline = time.monotonic() + budget

    def on_term(signum, frame):
        print(f"# signal {signum}: emitting early", file=sys.stderr,
              flush=True)
        emit()
        os._exit(1)

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    th = threading.Thread(target=worker, args=(deadline,), daemon=True)
    th.start()
    while not STATE["done"] and time.monotonic() < deadline:
        time.sleep(0.5)
    if not STATE["done"]:
        print(f"# deadline ({budget:.0f}s) hit in stage "
              f"{STATE['stage']}", file=sys.stderr, flush=True)
    emit()
    # the worker may be stuck in a device call; don't wait for it
    os._exit(exit_code() if STATE["done"] else 1)


if __name__ == "__main__":
    main()
