"""``repro_torch.serving`` -- async streaming serving on the grouped engine.

Port of ``repro.serving``: an ``AsyncLVLMServer`` pumps the engine's
iteration loop in the background and exposes each request as an
independent async token channel (``TokenStream``), with KV-watermark
admission control (``AdmissionController``: backpressure instead of pool
exhaustion, FIFO or SLO-slack drain order) and per-request SLO telemetry
(``MetricsRegistry``: TTFT / TPOT / JCT / queue-wait records on the
engine's virtual clock).

    server = lvlm.serve_async(EngineConfig(...), obs=True, profile=True)
    async with server:
        async for tok in server.submit(req):
            ...

The sync path (``LVLM.serve``) and this async path share the same Engine,
schedulers, decoder strategies and clock: at temperature 0 the streams
are bit-identical to ``serve``'s outputs.
"""
from repro_torch.serving.admission import (AdmissionConfig,
                                           AdmissionController)
from repro_torch.serving.metrics import MetricsRegistry, RequestRecord
from repro_torch.serving.server import AsyncLVLMServer, TokenStream

__all__ = [
    "AsyncLVLMServer", "TokenStream",
    "AdmissionConfig", "AdmissionController",
    "MetricsRegistry", "RequestRecord",
]
