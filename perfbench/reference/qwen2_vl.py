"""Plain float32 reference of Qwen2-VL-2B's language model as the port
serves it (arXiv:2409.12191), from the configuration file's own keys.

One pass over [projected patches | prompt tokens | served tokens but the
last], layer by layer; the logits at the positions that predicted the
served tokens. Departures from the published model, each the port's as
well:

- the ViT is not run: the inputs are its [Nv, hidden_size] patch
  embeddings, through the port's projector (``projector_width``: two
  square products with a tanh-approximate GELU between), not Qwen2-VL's
  merger over 2 x 2 patches;
- no bias on the q, k and v projections (Qwen2 has one);
- M-RoPE at the engine's positions, where the temporal, height and
  width streams are all ``arange(S)``: that is RoPE over the whole head
  with the halves convention, ``rope_theta``;
- attention is full causal: the configs' ``sliding_window`` does not
  bind at the lengths the cells send.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from reference.common import (causal_attention, exact_matmuls, mm, rd, rms,
                              rope, swiglu)


def served_logits(cfg, params, prompt, visual, served,
                  precision: str = "f32") -> torch.Tensor:
    """[len(served), vocab] float32 logits that predicted each served
    token, for one request: ``prompt`` token ids, ``visual`` patch
    embeddings [Nv, d] or None, ``served`` the tokens the program gave."""
    d = cfg["hidden_size"]
    h_, kh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h_
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    tok = params["embed"]["tok"]
    dev = tok.device
    with exact_matmuls():
        ids = torch.as_tensor(list(prompt) + list(served[:-1]),
                              dtype=torch.long, device=dev)
        x = tok[ids].float()
        nv = 0
        p = precision
        if visual is not None:
            ve = torch.as_tensor(np.asarray(visual), device=dev).float()
            pj = params["projector"]
            hv = F.gelu(mm(rd(ve, p), pj["w1"], p), approximate="tanh")
            x = torch.cat([mm(rd(hv, p), pj["w2"], p), x])
            nv = ve.shape[0]
        s = x.shape[0]
        pos = torch.arange(s, device=dev)
        lay = params["layers"]
        for i in range(cfg["num_hidden_layers"]):
            a = lay["attn"]
            h = rms(x, lay["ln1"]["scale"][i], eps, p)
            q = mm(h, a["wq"][i].reshape(d, -1), p).view(s, h_, hd)
            k = mm(h, a["wk"][i].reshape(d, -1), p).view(s, kh, hd)
            v = mm(h, a["wv"][i].reshape(d, -1), p).view(s, kh, hd)
            o = causal_attention(rd(rope(q, pos, theta), p),
                                 rd(rope(k, pos, theta), p), v,
                                 1.0 / math.sqrt(hd))
            x = rd(x + mm(rd(o.reshape(s, -1), p), a["wo"][i].reshape(-1, d),
                          p), p)
            h = rms(x, lay["ln2"]["scale"][i], eps, p)
            m = lay["mlp"]
            x = rd(x + swiglu(h, m["wi_gate"][i], m["wi_up"][i], m["wo"][i],
                              p), p)
            del q, k, v, o, h
        first = nv + len(prompt) - 1
        rows = rms(x[first:first + len(served)],
                   params["final_norm"]["scale"], eps, p)
        w = params["embed"]["unembed"] if "unembed" in params["embed"] \
            else tok.t()
        return mm(rows, w, p)
