"""CLI end-to-end tests, in-process via run_from_args (the reference does the
same with lib.rs:1558-1621)."""

import json

import pytest

from vgen_tpu.cli import run_from_args
from vgen_tpu.output import csv_escape


def test_csv_escape_plain():
    assert csv_escape("hello") == "hello"


def test_csv_escape_comma():
    assert csv_escape("[a-f]{1,2}") == '"[a-f]{1,2}"'


def test_csv_escape_quotes():
    assert csv_escape('say "hi"') == '"say ""hi"""'


def test_csv_escape_newline():
    assert csv_escape("line1\nline2") == '"line1\nline2"'


def test_verify_key1(capsys):
    rc = run_from_args(["verify", "-k", "0x" + "00" * 31 + "01"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH" in out
    assert "bc1qw508d6qejxtdg4y5r3zarvary0c5xw7kv8f3t4" in out
    assert "0x7E5F4552091A69125d5DfCb7b8C2659029395Bdf" in out


def test_verify_with_expected_match(capsys):
    rc = run_from_args(
        ["verify", "-k", "00" * 31 + "01", "-a",
         "1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH"]
    )
    assert rc == 0
    assert "MATCH!" in capsys.readouterr().out


def test_verify_wif_roundtrip(capsys):
    rc = run_from_args(
        ["verify", "-k", "KwDiBf89QgGbjEhKnhXJuH7LrciVrZi3qYjgd9M7rFU73sVHnoWn"]
    )
    assert rc == 0
    assert "1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH" in capsys.readouterr().out


def test_verify_bech32_case_normalization(capsys):
    rc = run_from_args(
        ["verify", "-k", "00" * 31 + "01", "-a",
         "BC1QW508D6QEJXTDG4Y5R3ZARVARY0C5XW7KV8F3T4"]
    )
    assert rc == 0
    assert "MATCH!" in capsys.readouterr().out


def test_verify_raw_eth_hex(capsys):
    rc = run_from_args(
        ["verify", "-k", "00" * 31 + "01", "-a",
         "7e5f4552091a69125d5dfcb7b8c2659029395bdf"]
    )
    assert rc == 0
    assert "MATCH!" in capsys.readouterr().out


def test_verify_mismatch(capsys):
    rc = run_from_args(
        ["verify", "-k", "00" * 31 + "01", "-a", "1BoGusAddressXXXXXXXXXXXXXXXXXXXXX"]
    )
    assert rc == 0
    assert "MISMATCH!" in capsys.readouterr().out


def test_estimate(capsys):
    rc = run_from_args(["estimate", "-p", "^1Ab"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "1 in 3,364" in out  # 58^2


def test_estimate_provider(capsys):
    rc = run_from_args(["estimate", "-p", "boha:b1000:1", "-l", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Pattern: ^1BgG" in out


def test_generate_quick(capsys):
    rc = run_from_args(
        ["generate", "-p", "^1", "--no-tui", "-q", "--device-batch-size",
         "256", "--backend", "cpu"]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "Address : 1" in out


def test_generate_minimal_output(capsys):
    rc = run_from_args(
        ["generate", "-p", "^1", "--no-tui", "-q", "-o", "minimal",
         "--device-batch-size", "256"]
    )
    out = capsys.readouterr().out.strip()
    assert rc == 0
    assert out.startswith(("K", "L"))  # compressed WIF


def test_generate_json_output(capsys):
    rc = run_from_args(
        ["generate", "-p", "^1", "--no-tui", "-q", "-o", "json",
         "--device-batch-size", "256"]
    )
    out = capsys.readouterr().out
    assert rc == 0
    data = json.loads(out)
    assert data["address"].startswith("1")
    assert data["format"] == "P2PKH"


def test_generate_file_output(tmp_path, capsys):
    path = tmp_path / "out.jsonl"
    rc = run_from_args(
        ["generate", "-p", "^1", "--no-tui", "-q", "-o", "jsonl",
         "--file", str(path), "--device-batch-size", "256"]
    )
    assert rc == 0
    data = json.loads(path.read_text().strip())
    assert data["address"].startswith("1")


def test_generate_p2sh_p2wpkh_cpu(capsys):
    # regression-parity: reference lib.rs:1607-1620
    rc = run_from_args(
        ["generate", "-p", "^3", "-f", "p2sh-p2wpkh", "--no-tui", "-q",
         "--no-gpu", "--cpu-batch-size", "50"]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "Address : 3" in out


def test_range_ethereum_no_panic(capsys):
    # regression-parity: reference #16 (lib.rs:1597-1606).  Here Ethereum is
    # device-supported; the command must simply succeed.
    rc = run_from_args(
        ["range", "--range", "1:FF", "-f", "ethereum", "--no-tui", "--no-gpu"]
    )
    assert rc == 0


def test_range_puzzle_small(capsys):
    # puzzle 8 range is tiny: exact-match via provider data
    rc = run_from_args(
        ["range", "-p", "boha:b1000:8", "--no-tui", "-o", "minimal",
         "--device-batch-size", "256", "--backend", "cpu"]
    )
    out = capsys.readouterr().out.strip()
    assert rc == 0
    from vgen_tpu.crypto.encode import wif_decode

    secret, compressed, _ = wif_decode(out)
    assert int.from_bytes(secret, "big") == 0xE0


def test_prefix_length_zero_rejected():
    # regression-parity: reference #27 (lib.rs:1583-1595)
    with pytest.raises(SystemExit):
        run_from_args(
            ["range", "-p", "boha:b1000:66", "-l", "0", "--no-tui"]
        )


def test_list_devices(capsys):
    rc = run_from_args(["list-devices", "--json"])
    out = capsys.readouterr().out
    assert rc == 0
    devs = json.loads(out)
    assert len(devs) >= 1


def test_invalid_pattern_errors(capsys):
    rc = run_from_args(["generate", "-p", "[bad", "--no-tui", "-q"])
    assert rc == 2


def test_charset_warning(capsys):
    # impossible Base58 chars warn; a tiny exhausting range keeps it finite
    rc = run_from_args(
        ["range", "-p", "^1OO", "--range", "100:110", "--no-tui", "--no-gpu"]
    )
    err = capsys.readouterr().err
    assert rc == 0
    assert "NEVER match" in err
    assert "Base58 excludes" in err


def test_range_with_explicit_range_and_count_zero(capsys):
    key = 0x123
    from vgen_tpu.crypto.address import AddressFormat, AddressGenerator

    addr = AddressGenerator(AddressFormat.P2PKH).generate(
        key.to_bytes(32, "big")
    ).address
    import re

    rc = run_from_args(
        ["range", "-p", f"^{re.escape(addr)}$", "--range", "100:200",
         "--no-tui", "-o", "minimal", "-c", "0", "--device-batch-size", "256"]
    )
    out = capsys.readouterr().out.strip()
    assert rc == 0
    assert out  # found the key


# -- device-backend resolution ---------------------------------------------


def test_resolve_use_device_no_device():
    from vgen_tpu.cli import resolve_use_device

    assert resolve_use_device("auto", no_device=True) is False
    assert resolve_use_device("gpu", no_device=True) is False


def test_resolve_use_device_backend_cpu_uses_jax_pipeline():
    from vgen_tpu.cli import resolve_use_device

    assert resolve_use_device("cpu", no_device=False) is True


def test_resolve_use_device_env_cpu_auto_native(monkeypatch, capsys):
    # JAX_PLATFORMS=cpu (the test env) + auto -> native CPU scanner, said
    # in one stderr line
    from vgen_tpu.cli import resolve_use_device

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert resolve_use_device("auto", no_device=False) is False
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "native CPU scanner" in err[0]


def test_resolve_use_device_env_cpu_gpu_conflict(monkeypatch):
    from vgen_tpu.cli import resolve_use_device

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    with pytest.raises(SystemExit) as exc:
        resolve_use_device("gpu", no_device=False)
    assert exc.value.code == 2


def test_resolve_use_device_probe_cpu_only(monkeypatch):
    # jax sees only CPU devices -> auto prefers the native scanner,
    # explicit gpu errors
    from vgen_tpu.cli import resolve_use_device

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    assert resolve_use_device("auto", no_device=False) is False
    with pytest.raises(SystemExit):
        resolve_use_device("gpu", no_device=False)


def test_generate_backend_gpu_without_gpu_exits_2(capsys):
    """--backend gpu never falls back: with only CPU devices the CLI
    exits 2 before scanning."""
    with pytest.raises(SystemExit) as exc:
        run_from_args(["generate", "-p", "^1", "--backend", "gpu",
                       "--no-tui", "-o", "minimal"])
    assert exc.value.code == 2
    captured = capsys.readouterr()
    assert "--backend gpu" in captured.err
    assert captured.out == ""


def test_backend_choices_are_auto_gpu_cpu():
    from vgen_tpu.cli import build_parser

    p = build_parser()
    sub = next(a for a in p._actions if a.dest == "command")
    for name in ("generate", "range"):
        backend = next(a for a in sub.choices[name]._actions
                       if a.dest == "backend")
        assert backend.choices == ["auto", "gpu", "cpu"]


@pytest.mark.parametrize("fmt", ["p2pkh", "p2pkh-uncompressed", "p2wpkh",
                                 "p2sh-p2wpkh", "p2tr", "ethereum"])
def test_format_choices_cover_all_six(fmt):
    from vgen_tpu.cli import build_parser

    args = build_parser().parse_args(["generate", "-p", "^1", "-f", fmt])
    assert args.format == fmt
