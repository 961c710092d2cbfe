"""The yardstick's arithmetic: the bytes each kernel must move, and the
device's peaks.

The byte counts are frozen copies of ``chip_smoke.py``'s ``chain_bytes``
and ``rotate_bytes``: each input byte read once and each output byte
written once, whatever the kernel reads again.  A roofline share is the
least time the card could take (bytes over its peak bandwidth) divided
by the time the profiler gives the kernel.
"""

from __future__ import annotations

#: NVIDIA H100 SXM (80 GB HBM3), published peaks at the 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def peak_bytes_per_s(kind: str):
    """The published HBM bandwidth of the card named ``kind``, or None for
    a device the table does not hold (no share is made against a guess)."""
    return PEAKS.get(kind, {}).get("hbm_bytes_per_s")


def chain_bytes(S: int, B: int, C_in: int) -> int:
    """K1 (csrc/augment_full.cu) for B images of crop S: each crop pixel's
    C_in bytes read once, each RGBA pixel written once, the shift vectors,
    the item rows and the enhance parameters."""
    return B * (S * S * (C_in + 4) + 2 * 4 * S + 16 + 32)


def rotate_bytes(S: int, B: int, C: int) -> int:
    """K2 (csrc/shear_rotate.cu) for B images of side S and C channels:
    each pixel read and written once, the shift vectors and the D4 code."""
    return B * (2 * S * S * C + 2 * 4 * S + 4)
