"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets: the SXM part's dense rates, without sparsity, at its full power
limit).  A card whose name matches no row has no peak here, and the
readers that need one return nothing for it."""
from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {"bf16_flops": 989.4e12, "fp8_flops": 1978.9e12, "tf32_flops": 494.7e12,
             "fp32_flops": 66.9e12, "hbm_bytes": 3.35e12},
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    for key, row in PEAKS.items():
        if key in kind:
            return row
    return None
