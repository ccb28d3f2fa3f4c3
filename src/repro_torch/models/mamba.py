"""Mamba-2 (SSD: state-space duality) block, chunked-parallel and recurrent.

Port of ``repro.models.mamba``. The full-sequence path is the chunked SSD
algorithm: a quadratic, attention-like form inside chunks of ``chunk``
tokens, and a linear recurrence over the chunk states (the reference's
``lax.scan``, a Python loop over the T / chunk chunks here). The decode
path is the O(1) recurrence h' = exp(dt A) h + dt B x, y = C h' + D x,
with the state cache {"conv": the rolling conv window, "ssd": h}.

Neither is a Pallas kernel in the reference, so plain PyTorch on the card
is their port (ROADMAP queue B). The chunk is the caller's: the hybrid
family takes the largest of 128, 64, ..., 1 that divides T, as the
reference does, so a 300-token prompt runs 75 chunk steps of 4 tokens.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, spec
from repro_torch.sharding.context import Arg, local, matmul


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_state_dim


def mamba_specs(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_inner, nheads, n = _dims(cfg)
    conv_ch = d_inner + 2 * n
    return {
        # order: [z (d_inner) | xBC (d_inner + 2N) | dt (nheads)]
        "in_proj": spec((d, 2 * d_inner + 2 * n + nheads),
                        ("embed", "ssm_inner")),
        "conv_w": spec((cfg.ssm_conv_dim, conv_ch), (None, "ssm_inner"),
                       scale=0.5),
        "conv_b": spec((conv_ch,), ("ssm_inner",), init="zeros"),
        "dt_bias": spec((nheads,), ("ssm_heads",), init="zeros"),
        "a_log": spec((nheads,), ("ssm_heads",), init="ones"),
        "d_skip": spec((nheads,), ("ssm_heads",), init="ones"),
        "norm_scale": spec((d_inner,), ("ssm_inner",), init="ones"),
        "out_proj": spec((d_inner, d), ("ssm_inner", "embed")),
    }


def mamba_cache_specs(cfg, batch: int):
    d_inner, nheads, n = _dims(cfg)
    conv_ch = d_inner + 2 * n
    return {
        "conv": spec((batch, cfg.ssm_conv_dim - 1, conv_ch),
                     ("batch", None, "ssm_inner"), init="zeros"),
        "ssd": spec((batch, nheads, cfg.ssm_head_dim, n),
                    ("batch", "ssm_heads", None, None), init="zeros",
                    dtype="float32"),
    }


def _split_proj(cfg, proj):
    d_inner, nheads, n = _dims(cfg)
    return (proj[..., :d_inner], proj[..., d_inner:2 * d_inner + 2 * n],
            proj[..., 2 * d_inner + 2 * n:])


def _gated_rmsnorm(y, z, scale, eps=1e-6):
    y = y * F.silu(z.float())
    var = y.square().mean(-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * scale.float()


def _segsum(a):
    """a [..., c] -> lower-triangular pairwise cumulative sums [..., c, c]
    (-inf above the diagonal)."""
    c = a.shape[-1]
    cs = torch.cumsum(a, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, -torch.inf)


def _chunk_scan(h, s_chunk, chunk_decay):
    """The recurrence over the chunk states (the reference's ``lax.scan``):
    h [B,H,P,N], s_chunk [B,nc,H,P,N], chunk_decay [B,nc,H]. Returns (the
    state entering each chunk [B,nc,H,P,N], the final state)."""
    h_prevs = []
    for zi in range(s_chunk.shape[1]):
        h_prevs.append(h)
        h = torch.addcmul(s_chunk[:, zi], h,
                          chunk_decay[:, zi, :, None, None])
    return torch.stack(h_prevs, 1), h


#: the small per-channel / per-head params the SSD core reads
_CORE = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "norm_scale")


def _core(fn, proj, states, p):
    """``fn(proj, *states, params)`` on each rank's local rows under a mesh
    (``sharding.context.local``: batch-sharded, the small params
    replicated); outputs [B, ...] (y and the new states)."""
    names = [k for k in _CORE if k in p]

    def run(proj, *rest):
        return fn(proj, *rest[:len(states)],
                  dict(zip(names, rest[len(states):])))
    return local(run, [Arg(proj, 0)] + [Arg(st, 0) for st in states]
                 + [Arg(p[k]) for k in names], [(0, None)] * 3)


def mamba_forward(p, x, cfg, *, chunk: int = 128,
                  cache=None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence SSD. x [B,T,d] -> y [B,T,d], and with ``cache`` (its
    ``ssd`` the initial state) the final state {"conv", "ssd"}. Between
    the two projections the SSD runs per row (``_core``)."""
    proj = matmul(x, p["in_proj"])
    y, h, conv_state = _core(
        lambda proj, h0, conv0, q: _ssd(q, cfg, proj, chunk, h0, conv0),
        proj, [None if cache is None else cache[k] for k in ("ssd", "conv")],
        p)
    out = matmul(y.to(x.dtype), p["out_proj"])
    if cache is None:
        return out, {}
    return out, dict(cache, conv=conv_state, ssd=h)


def _ssd(p, cfg, proj, chunk, h0, conv0):
    """The SSD between the projections: proj [B,T,*] -> (y [B,T,d_inner]
    float32, the final state, the conv state)."""
    b, t = proj.shape[:2]
    d_inner, nheads, n = _dims(cfg)
    hd = cfg.ssm_head_dim

    z, xbc, dt = _split_proj(cfg, proj)

    # depthwise causal conv over xBC (kernel ssm_conv_dim)
    kw = cfg.ssm_conv_dim
    xbc_pad = F.pad(xbc, (0, 0, kw - 1, 0))
    conv = sum(xbc_pad[:, i:i + t] * p["conv_w"][i] for i in range(kw))
    conv = F.silu(conv + p["conv_b"])
    xs = conv[..., :d_inner].reshape(b, t, nheads, hd)
    bm = conv[..., d_inner:d_inner + n]                      # [B,T,N]
    cm = conv[..., d_inner + n:]                             # [B,T,N]

    dt = F.softplus(dt.float() + p["dt_bias"].float())       # [B,T,H]
    a = -torch.exp(p["a_log"].float())                       # [H]
    da = dt * a                                              # [B,T,H]

    # ---- chunked SSD -----------------------------------------------------
    c = min(chunk, t)
    if t % c:
        raise ValueError(f"mamba_forward: T = {t} is not a multiple of the "
                         f"chunk {c}")
    nc = t // c
    xs_c = xs.reshape(b, nc, c, nheads, hd).float()
    bm_c = bm.reshape(b, nc, c, n).float()
    cm_c = cm.reshape(b, nc, c, n).float()
    dt_c = dt.reshape(b, nc, c, nheads)
    da_c = da.reshape(b, nc, c, nheads)
    da_cs = torch.cumsum(da_c, 2)                            # [B,nc,c,H]

    # intra-chunk (quadratic within a chunk)
    l = torch.exp(_segsum(da_c.movedim(-1, -2)))             # [B,nc,H,c,c]
    scores = torch.einsum("bzin,bzjn->bzij", cm_c, bm_c)     # [B,nc,c,c]
    dtx = xs_c * dt_c[..., None]                             # [B,nc,c,H,P]
    y_intra = torch.einsum("bzhij,bzjhp->bzihp", scores[:, :, None] * l,
                           dtx)

    # chunk final states: S_z = sum_j exp(da_cs[-1] - da_cs[j]) B_j x_j^T
    decay_states = torch.exp(da_cs[:, :, -1:, :] - da_cs)    # [B,nc,c,H]
    s_chunk = torch.einsum("bzjn,bzjhp->bzhpn", bm_c,
                           dtx * decay_states[..., None])

    # inter-chunk recurrence over the nc chunks
    chunk_decay = torch.exp(da_cs[:, :, -1, :])              # [B,nc,H]
    h = (h0.float() if h0 is not None
         else torch.zeros((b, nheads, hd, n), device=proj.device))
    h_prevs, h = _chunk_scan(h, s_chunk, chunk_decay)       # [B,nc,H,P,N]

    # inter-chunk contribution: C_i . (decay_in * h_prev)
    decay_in = torch.exp(da_cs)                              # [B,nc,c,H]
    y_inter = torch.einsum("bzin,bzhpn->bzihp", cm_c, h_prevs) \
        * decay_in[..., None]

    y = (y_intra + y_inter).reshape(b, t, nheads, hd)
    y = y + xs.float() * p["d_skip"].float()[None, None, :, None]
    y = _gated_rmsnorm(y.reshape(b, t, d_inner), z, p["norm_scale"])
    if t >= kw - 1 or conv0 is None:
        conv_state = xbc[:, max(t - (kw - 1), 0):, :]
    else:
        conv_state = torch.cat([conv0, xbc], 1)[:, -(kw - 1):]
    return y, h, conv_state


def mamba_decode_step(p, x, cfg, cache) -> Tuple[torch.Tensor, Dict]:
    """x [B,1,d]: the O(1) recurrent update. Returns (y [B,1,d], the new
    {"conv", "ssd"})."""
    y, window, h = _core(
        lambda proj, conv, ssd, q: _ssd_step(q, cfg, proj, conv, ssd),
        matmul(x, p["in_proj"]), [cache["conv"], cache["ssd"]], p)
    return (matmul(y.to(x.dtype), p["out_proj"]),
            dict(cache, conv=window, ssd=h))


def _ssd_step(p, cfg, proj, conv_state, ssd):
    """One token of the recurrence between the projections: proj [B,1,*]
    -> (y [B,1,d_inner], the new conv window, the new state)."""
    b = proj.shape[0]
    d_inner, nheads, n = _dims(cfg)
    hd = cfg.ssm_head_dim

    z, xbc, dt = _split_proj(cfg, proj)                        # [B,1,*]
    window = torch.cat([conv_state, xbc], 1)                # [B,kw,ch]
    conv = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"])
                  + p["conv_b"])
    xs = conv[:, :d_inner].reshape(b, nheads, hd).float()
    bm = conv[:, d_inner:d_inner + n].float()
    cm = conv[:, d_inner + n:].float()

    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"].float())   # [B,H]
    a = -torch.exp(p["a_log"].float())
    dec = torch.exp(dtv * a)                                # [B,H]
    h = ssd.float() * dec[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", dtv[..., None] * xs, bm)
    y = torch.einsum("bn,bhpn->bhp", cm, h)
    y = y + xs * p["d_skip"].float()[None, :, None]
    return (_gated_rmsnorm(y.reshape(b, 1, d_inner), z, p["norm_scale"]),
            window[:, 1:], h)
