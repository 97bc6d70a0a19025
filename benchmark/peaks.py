"""Published peaks of the cards the benchmark knows, by `torch.cuda.get_device_name()`.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at its full 700 W
power limit: 495 TFLOP/s in TF32 on the tensor cores (the rate of the
fp32-accurate products the program runs, which are TF32 passes), 67
TFLOP/s in float32 outside them, 3.35 TB/s of HBM3. A card set below 700 W
runs slower: the run line records the card's power limit beside its shares.
"""

from __future__ import annotations

from typing import Optional

H100_SXM = {"tf32_flops": 495e12, "hbm_bytes_per_s": 3.35e12}

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks(device_name: str) -> Optional[dict]:
    return PEAKS.get(device_name)


def roofline_share(flops: float, bytes_moved: float, seconds: float, peak: dict) -> float:
    """Percent of the roofline bound: the larger of flops over the TF32 rate
    and bytes over HBM bandwidth (each metric's file says which binds)."""
    bound = max(flops / peak["tf32_flops"], bytes_moved / peak["hbm_bytes_per_s"])
    return 100.0 * bound / seconds
