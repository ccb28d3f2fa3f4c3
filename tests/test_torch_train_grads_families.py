"""``Model.loss`` and its gradients, the port against the JAX reference:
the hybrid (zamba2-1.2b: Mamba-2 and the windowed
shared block, 80 tokens past its 64-token window), audio (whisper-tiny:
frames, non-causal encoder and cross attention) and ssm (rwkv6-3b)
families.

Both models get the same weights (the port's init, carried to the
reference key for key) and the same batch (the reference's
``make_batch``, step 1): the loss within 1e-5 (relative), the scalar aux
(MoE's ``lb_loss``) too, and each gradient leaf within 1e-4 of its
largest |g|, in float32 (rwkv6-3b's gradients against the reference's float64 ones,
``_train_grads.FLOAT32_NOISY``); remat on gives the port the same loss and
gradients as remat off. The port's gradients run through
``FlashAttentionFn``'s plain backward on the CPU; the card's kernel is
held against that in ``tests/test_torch_cuda.py``. The helpers are
``tests/_train_grads.py``'s."""
import pytest

from _train_grads import arch_case, check_loss_and_grads, check_remat

ARCHS = {   # arch: SyntheticDataConfig batch / seq_len
    "zamba2-1.2b": (1, 80),          # past its 64-token window
    "whisper-tiny": (2, 8),
    "rwkv6-3b": (2, 8),
}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch_pair(request):
    return arch_case(request.param, ARCHS[request.param])


def test_loss_and_grads_match_reference(arch_pair):
    check_loss_and_grads(*arch_pair)


def test_remat_gives_the_same_loss_and_grads(arch_pair):
    check_remat(*arch_pair)
