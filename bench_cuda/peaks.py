"""Published dense peaks of the cards the benchmark runs on, and the least
time of a piece of work on them (a copy of ``chip_smoke.PEAKS`` and
``chip_smoke.bound``, kept here so that a later change to the smoke script
cannot move the yardstick).

Peaks: NVIDIA data sheets, SXM parts, dense rates without sparsity; bytes/s
of device memory and operations/s by type. They assume the card's full power
limit (700 W on an H100 SXM); the harness prints the card's limit beside
every share of a peak.
"""

from __future__ import annotations

PEAKS = {
    "H100": {"bytes": 3.35e12, "bf16": 989e12, "f32": 67e12,
             "int8": 1979e12},
    "H200": {"bytes": 4.8e12, "bf16": 989e12, "f32": 67e12,
             "int8": 1979e12},
}


def peaks_for(device_name: str) -> dict | None:
    """The peaks of a card by its name, None for a card not in the table."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


def bound_s(nbytes: float, ops: float, ops_rate: float,
            peaks: dict) -> float:
    """Least seconds for ``ops`` operations at ``ops_rate`` that move
    ``nbytes`` bytes: the larger of the two times."""
    return max(nbytes / peaks["bytes"], ops / ops_rate)
