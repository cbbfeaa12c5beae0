"""The card: the published peaks of the H100 family, and the check that a run
has the cards its cell asks for.

The peaks are copied from ``chip_smoke.py`` (``CARD_PEAKS``, NVIDIA's data
sheets: dense rates without sparsity, at the full power limit), so that a
change to the program cannot move the yardstick. A share of a peak is stated
against these numbers with the card's power limit beside it."""

from __future__ import annotations

import subprocess

# (name fragment, HBM bytes/s, f32 CUDA-core FLOP/s, bf16 FLOP/s, int8 OP/s, TF32 FLOP/s);
# the first fragment found in the card's name wins, so the longer names come first
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 756e12, 1513e12, 378e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12, 1671e12, 418e12),
    ("H100", 3.35e12, 67e12, 989e12, 1979e12, 495e12),
    ("H200", 4.8e12, 67e12, 989e12, 1979e12, 495e12),
)


def peaks_of(name):
    """{"bw", "f32", "bf16", "int8", "tf32"} of the card called ``name``;
    KeyError for a card the table lacks (a share of an unknown peak is no
    number)."""
    for key, bw, f32, bf16, int8, tf32 in CARD_PEAKS:
        if key in name:
            return {"bw": bw, "f32": f32, "bf16": bf16, "int8": int8, "tf32": tf32}
    raise KeyError(f"no peak entry for card {name!r}")


def require_cards(n):
    """Raises SystemExit(3) unless torch sees at least ``n`` CUDA devices."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gpubench: torch.cuda.is_available() is False; the benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"gpubench: the cell asks for {n} cards, torch sees {torch.cuda.device_count()}")


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None
