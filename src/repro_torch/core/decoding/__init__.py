"""Decoding substrate of the port (sampling; speculative and early exit
come with slice 4)."""
from repro_torch.core.decoding.sampling import (
    greedy, sample_probs, sample_token, temperature_sample)
