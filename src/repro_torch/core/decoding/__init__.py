"""Decoding substrate of the port: sampling, speculative decoding and
early exit (port of ``repro.core.decoding``; the public entry point is
``repro_torch.api``, ``GenerationConfig(decoder=...)``)."""
from repro_torch.core.decoding.sampling import (
    greedy, sample_probs, sample_token, temperature_sample)
from repro_torch.core.decoding.speculative import (
    SpecStats, accept_block, acceptance_rate, batched_draft_block,
    draft_block, lantern_neighbourhood_from_params, speculative_generate)
from repro_torch.core.decoding.early_exit import (
    early_exit_decode_step, layer_confidences)
