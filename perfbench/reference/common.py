"""Plain float32 building blocks of the references (torch operations only;
nothing of the program is imported).

``precision="fp8"`` is the control, the step below the configurations'
bf16: the bf16 pipeline (every product's output, every norm's output and
the residual stream rounded to bf16, as the program keeps them) with
every product with a weight taking its weight and its input rounded to
float8 e4m3 (the weight per output column, the input per row, each
scaled to e4m3's largest finite value). Attention's scores and softmax
stay float32 in both.
"""
from __future__ import annotations

import contextlib
import math

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_matmuls():
    """float32 products in float32: TF32 off for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with one scale along ``dim``'s slices."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def rd(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as the precision keeps it: rounded to bf16 in the control."""
    return t.bfloat16().float() if precision == "fp8" else t


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x [..., k] @ w [k, n] in float32 (or the fp8 control)."""
    w = w.float()
    if precision == "fp8":
        return rd(fp8(x, -1) @ fp8(w, 0), precision)
    return x @ w


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float,
        precision: str = "f32") -> torch.Tensor:
    return rd(x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
              * scale.float(), precision)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [S, H, D] at positions pos [S], the halves
    convention: pairs (i, i + D/2)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                          device=x.device) / d))
    ang = pos.double()[:, None] * freqs
    c, s = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def causal_attention(q, k, v, scale: float, block: int = 1024):
    """softmax(q k^T * scale, causal) v, in query blocks: q [S, H, D],
    k [S, K, D], v [S, K, Dv] with H a multiple of K (grouped queries)."""
    s, h, _ = q.shape
    kh = k.shape[1]
    g = h // kh
    out = torch.empty((s, h, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    kt = k.permute(1, 2, 0)                               # [K, D, S]
    vt = v.permute(1, 0, 2)                               # [K, S, Dv]
    for i in range(0, s, block):
        qb = q[i:i + block]                               # [b, H, D]
        b = qb.shape[0]
        n = i + b
        qg = qb.reshape(b, kh, g, -1).permute(1, 0, 2, 3).reshape(kh, b * g, -1)
        sc = (qg @ kt[:, :, :n]) * scale                  # [K, b*g, n]
        sc = sc.view(kh, b, g, n)
        qi = torch.arange(i, n, device=q.device)[None, :, None, None]
        ki = torch.arange(n, device=q.device)[None, None, None, :]
        sc = sc.masked_fill(ki > qi, -math.inf)
        p = torch.softmax(sc, -1).view(kh, b * g, n)
        o = (p @ vt[:, :n]).view(kh, b, g, -1).permute(1, 0, 2, 3)
        out[i:n] = o.reshape(b, h, -1)
    return out


def swiglu(x, wg, wu, wo, precision: str) -> torch.Tensor:
    h = torch.nn.functional.silu(mm(x, wg, precision)) * mm(x, wu, precision)
    return mm(rd(h, precision), wo, precision)
