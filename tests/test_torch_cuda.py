"""On-card tests of the port: each CUDA kernel against its plain version.

Marked ``cuda``; every test skips when no CUDA device is present (the
decision is made inside the fixture, never at import). The file imports
no JAX, so on a machine with a card and no JAX it runs as

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa

pytestmark = pytest.mark.cuda

# float32 kernels repeat the plain arithmetic up to summation order;
# bfloat16 kernels round their probabilities to bf16 for the tensor-core
# product and their output to bf16 (one bf16 ulp at |x|~2 is 1.6e-2)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(b=1, h=4, kvh=2, sq=100, sk=100, d=64),
    dict(b=2, h=6, kvh=2, sq=130, sk=130, d=128, window=40),
    dict(b=1, h=2, kvh=2, sq=17, sk=96, d=64, kv_len=80, q_offset=50),
    dict(b=1, h=4, kvh=1, sq=33, sk=200, d=128, kv_len=150),
    dict(b=1, h=2, kvh=1, sq=70, sk=64, d=64, causal=False, kv_len=40),
    dict(b=1, h=2, kvh=1, sq=90, sk=64, d=64, q_offset=-20),  # keyless rows
])
def test_flash_kernel_matches_plain(dev, dtype, case):
    rng = np.random.default_rng(0)
    c = dict(case)
    b, h, kvh, sq, sk, d = (c.pop(x) for x in ("b", "h", "kvh", "sq", "sk",
                                                "d"))
    q = _randn(rng, (b, h, sq, d), dtype, dev)
    k = _randn(rng, (b, kvh, sk, d), dtype, dev)
    v = _randn(rng, (b, kvh, sk, d), dtype, dev)
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, **c)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    ref = fa.flash_attention_plain(q, k, v, **c)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,kvh,page", [(64, 4, 2, 16), (128, 12, 2, 16),
                                          (64, 16, 1, 5)])
def test_paged_kernel_matches_plain(dev, dtype, d, h, kvh, page):
    rng = np.random.default_rng(1)
    b, pps = 3, 7
    p_total = b * pps + 2
    q = _randn(rng, (b, h, d), dtype, dev)
    kp = _randn(rng, (p_total, page, kvh, d), dtype, dev)
    vp = _randn(rng, (p_total, page, kvh, d), dtype, dev)
    table = torch.from_numpy(rng.permutation(p_total)[:b * pps]
                             .reshape(b, pps).astype(np.int32)).to(dev)
    seq = torch.tensor([0, 1, pps * page - 3], dtype=torch.int32, device=dev)
    out = pa.paged_attention(q, kp, vp, table, seq)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(q, kp, vp, table, seq)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 2, 8, 32, device=dev)
    with pytest.raises(ValueError):        # head dim 32 has no kernel
        fa.flash_attention(q, q[:, :1], q[:, :1])
    q = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):        # neither float32 nor bfloat16
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 3, 8, 64, device=dev)
    with pytest.raises(ValueError):        # 3 q heads over 2 kv heads
        fa.flash_attention(q, q[:, :2], q[:, :2])
    qd = torch.zeros(2, 4, 64, device=dev)
    pages = torch.zeros(4, 16, 2, 64, device=dev)
    table = torch.zeros(3, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):        # table rows != batch
        pa.paged_attention(qd, pages, pages, table,
                           torch.ones(2, dtype=torch.int32, device=dev))
