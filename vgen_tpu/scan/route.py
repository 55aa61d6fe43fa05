"""The execution route of a scan, chosen once per platform.

Every platform-dependent choice of the scan path lives here, so the
scanners, the mesh and the limb arithmetic ask one place
instead of testing "not CPU" each on their own:

* ``gpu``: the XLA pipeline of ops/pipeline.py, k_sub key windows per
  dispatch as one batch (``packed_xla_scan_step``).
* ``cpu``: the same step, one window per dispatch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from vgen_tpu.crypto.address import AddressFormat
from vgen_tpu.ops import pipeline

PLATFORMS = ("gpu", "cpu")

# Key windows per dispatch on the gpu.
GPU_K_SUB = 8

# Expected interval-prefilter survivors per window above which the hybrid
# path is not worth the host-side regex work per survivor.
PREFILTER_MAX_SURVIVORS = 8.0


@dataclass(frozen=True)
class Route:
    """kind: "range" compares the format's hashed value against hash160
    intervals (anchored prefixes, pattern/intervals.py); "dfa" encodes the
    address on the device and runs the pattern's DFA.  glv: check the 6 GLV
    endomorphism variants of every key (random scans only).  k_sub: key
    windows per dispatch."""

    kind: str
    glv: bool
    k_sub: int


def check_platform(platform: str) -> str:
    if platform not in PLATFORMS:
        raise ValueError(
            f"unsupported JAX platform {platform!r}; expected one of "
            f"{PLATFORMS}"
        )
    return platform


def glv_allowed(fmt: AddressFormat, is_range: bool) -> bool:
    """Random scans may substitute any of the 6 variants {±k, ±λk, ±λ²k}
    for a window key; range scans must report keys inside [start, end]."""
    return not is_range and fmt in pipeline.GLV_FORMATS


def plan_intervals(pattern, fmt: AddressFormat, batch: int,
                   is_range: bool) -> Optional[List[Tuple[int, int]]]:
    """Intervals to scan with: the exact compilation when the pattern is an
    anchored literal, else the longest-prefix over-approximation when it is
    selective enough (expected survivors per window within
    PREFILTER_MAX_SURVIVORS -- the drain regex-filters survivors on the
    host either way, so both are sound).  None -> DFA path."""
    ivs = pattern.match_intervals(fmt)
    if ivs is not None:
        return ivs
    pf = pattern.prefilter_intervals(fmt)
    if pf is None:
        return None
    pf_ivs, p = pf
    mult = 6 if glv_allowed(fmt, is_range) else 1
    return pf_ivs if p * batch * mult <= PREFILTER_MAX_SURVIVORS else None


def route(platform: str, fmt: AddressFormat, ivs, is_range: bool,
          k_sub: int = GPU_K_SUB) -> Route:
    """The compiled step for one scan: (platform, format, planned
    intervals or None, range scan?) -> Route."""
    return Route(
        kind="range" if ivs is not None else "dfa",
        glv=glv_allowed(fmt, is_range),
        k_sub=windows_per_dispatch(platform, k_sub),
    )


def windows_per_dispatch(platform: str, k_sub: int = GPU_K_SUB) -> int:
    return k_sub if check_platform(platform) == "gpu" else 1


def exact_f32_dots(platform: str) -> bool:
    """Whether u256.mul_cols may use its f32-dot form.  Its operands are
    16-bit halves, which TF32 (the gpu's default f32 matmul, 11-bit
    significand) rounds; the gpu uses the integer limb-row schoolbook."""
    return check_platform(platform) == "cpu"
