"""CLI argument helpers (counterpart of sdr_tpu/utils/args.py).

``parse_size`` accepts decimal numbers with K/M/G suffixes ("90.2M" ->
90200000) for frequencies, sample rates and block sizes.
"""

from __future__ import annotations

from decimal import Decimal

__all__ = ["parse_size"]

_SUFFIX = {"K": 10 ** 3, "M": 10 ** 6, "G": 10 ** 9}


def parse_size(s: str) -> int:
    """Parse '1280K', '90.2M', '1.5G', or plain '48000' to an int.

    Decimal arithmetic so '90.2M' is exactly 90200000."""
    s = s.strip()
    if not s:
        raise ValueError("empty size")
    mult = 1
    if s[-1].upper() in _SUFFIX:
        mult = _SUFFIX[s[-1].upper()]
        s = s[:-1]
    value = Decimal(s) * mult
    if value != value.to_integral_value():
        raise ValueError(f"size {s} with multiplier {mult} is not integral")
    return int(value)
