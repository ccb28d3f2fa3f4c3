"""``repro_torch.api.video`` -- facade surface for video-token compression.

Port of ``repro.api.video``: the video-specific compression schedulers
(temporal merge, LLaMA-VID, DyCoke ratios, Dynamic-VLM budgeting,
FrameFusion) live in the internal layer; user code imports them from
here. The reference also exports ``select_streaming``, the streaming KV
eviction policy: that is KV selection and arrives with the KV-cache
slice (ROADMAP A9). The generic per-request strategies remain
``repro_torch.api.compressors``.
"""
from repro_torch.core.token_compression.video import (
    dycoke_ratio, dynamic_compress, frame_similarity, framefusion,
    llama_vid_compress, temporal_merge)

__all__ = [
    "frame_similarity", "temporal_merge", "llama_vid_compress",
    "dycoke_ratio", "dynamic_compress", "framefusion",
]
