"""Visual-token compression of the port (survey dim 1): pruning, merging,
video compression and the per-request strategy policy. Port of
``repro.core.token_compression``; plain PyTorch on the request's device
(the reference computes them with ``jnp``, never in Pallas)."""
from repro_torch.core.token_compression.pruning import (
    PRUNERS, prune_fastv, prune_sparsevlm, prune_l2, prune_divprune,
    prune_cdpruner, pyramiddrop_schedule)
from repro_torch.core.token_compression.merging import (
    tome_merge, tome_to_count, prune_then_merge)
from repro_torch.core.token_compression.video import (
    temporal_merge, llama_vid_compress, dycoke_ratio, dynamic_compress,
    framefusion, frame_similarity)
from repro_torch.core.token_compression.policy import (
    compress_visual_tokens, fastv_scores_from_attention)
