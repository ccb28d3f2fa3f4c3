"""Serving layer of the port (engine, schedulers, requests, cost model).

The public entry point is ``repro_torch.api`` (``LVLM.serve``)."""
from repro_torch.core.serving.disaggregation import CostModel
from repro_torch.core.serving.engine import (
    Engine, EngineConfig, SamplingEngineDecoder)
from repro_torch.core.serving.request import (
    Request, SLO, State, percentiles, slo_attainment, summarize)
from repro_torch.core.serving.scheduler import (
    SCHEDULERS, IterationPlan, StaticBatcher, ContinuousBatcher,
    MLFQScheduler, ChunkedPrefillScheduler)
