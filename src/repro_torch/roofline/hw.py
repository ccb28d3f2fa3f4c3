"""Hardware constants of the port: the target card, and the KV link.

Port of ``repro.roofline.hw``'s ``HW`` dataclass with the port's card, an
NVIDIA H100 SXM (NVIDIA's data sheet: dense rates without sparsity, at
the 700 W power limit), beside ``KV_LINK_GBPS``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops_bf16: float      # per chip, dense
    hbm_bw: float               # bytes/s per chip
    ici_bw: float               # bytes/s per link (NVLink, each way)
    hbm_bytes: float            # capacity per chip
    peak_flops_f32: float = 0.0  # per chip, outside the tensor cores


H100_SXM = HW(
    name="h100-sxm",
    peak_flops_bf16=989e12,     # 989 TFLOP/s bf16 dense
    hbm_bw=3.35e12,             # 3.35 TB/s HBM3
    ici_bw=450e9,               # NVLink 900 GB/s, 450 each way
    hbm_bytes=80e9,             # 80 GB
    peak_flops_f32=67e12,       # 67 TFLOP/s float32 (FMA units)
)

# Inter-pool KV link bandwidth in GB/s: the one number every KV-movement
# model shares (disaggregated prefill->decode transfer, cluster prefix-tier
# installs). A modelling constant of the virtual clock, not a measurement.
KV_LINK_GBPS = 32.0
