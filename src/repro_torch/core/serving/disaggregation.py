"""Analytic per-iteration cost model of the serving engine's virtual clock.

Port of ``CostModel`` from ``repro.core.serving.disaggregation`` (the
disaggregated-pool simulator comes with slice 6). Pure arithmetic, so the
port's virtual-clock TTFT/TPOT/JCT equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses

from repro_torch.roofline.hw import KV_LINK_GBPS


@dataclasses.dataclass
class CostModel:
    """us-per-token costs for one instance (chip group)."""
    prefill_us_per_token: float = 15.0     # compute-bound
    decode_us_per_token: float = 800.0     # memory-bound (one step, whole batch)
    decode_us_per_ctx_token: float = 0.002  # cache-read component per ctx token
    kv_bytes_per_token: int = 0            # transfer size for disaggregation
    transfer_gbps: float = KV_LINK_GBPS    # inter-pool link (GB/s)

    def prefill_time(self, n_tokens: int) -> float:
        return self.prefill_us_per_token * n_tokens * 1e-6

    def decode_step_time(self, batch: int, mean_ctx: float) -> float:
        return (self.decode_us_per_token
                + self.decode_us_per_ctx_token * mean_ctx * batch) * 1e-6

    def transfer_time(self, prompt_tokens: int) -> float:
        if not self.kv_bytes_per_token:
            return 0.0
        return (self.kv_bytes_per_token * prompt_tokens
                / (self.transfer_gbps * 1e9))
