"""vgen-tpu: vanity-address generation and string-matching framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of oritwoen/vgen
(reference layer map: /root/reference/src/lib.rs:9-12 public API).  The entire
keygen -> EC -> hash -> encode -> regex-match pipeline runs on the device; the host
only decodes winning keys.

Public API (mirrors the reference's re-exports, lib.rs:9-12):
  AddressFormat, AddressGenerator, GeneratedAddress  -- crypto/address.py
  Pattern                                            -- pattern/
  ScanConfig, ScanResult, scan, scan_with_progress,
  benchmark, ProgressCallback                        -- scan/
"""

__version__ = "0.1.0"

from vgen_tpu.crypto.address import (
    AddressFormat,
    AddressGenerator,
    GeneratedAddress,
)

_LAZY = {
    "Pattern": ("vgen_tpu.pattern", "Pattern"),
    "ScanConfig": ("vgen_tpu.scan.scanner", "ScanConfig"),
    "ScanResult": ("vgen_tpu.scan.scanner", "ScanResult"),
    "benchmark": ("vgen_tpu.scan.scanner", "benchmark"),
    "scan": ("vgen_tpu.scan.scanner", "scan"),
    "scan_with_progress": ("vgen_tpu.scan.scanner", "scan_with_progress"),
    "ProgressCallback": ("vgen_tpu.scan.scanner", "ProgressCallback"),
}


def __getattr__(name):
    # Lazy: importing the scanner pulls in jax; keep `import vgen_tpu` light
    # for oracle-only users (and fast CLI startup for `verify`/`estimate`).
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(name)

__all__ = [
    "AddressFormat",
    "AddressGenerator",
    "GeneratedAddress",
    "Pattern",
    "ScanConfig",
    "ScanResult",
    "benchmark",
    "scan",
    "scan_with_progress",
    "__version__",
]
