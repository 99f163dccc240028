"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet,
SXM part, dense rates, at the full power limit of 700 W). A card not
listed here has no peak, and a share of one is not reported."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(device_name: str) -> float | None:
    return PEAKS.get(device_name, {}).get("hbm_bytes_per_s")
