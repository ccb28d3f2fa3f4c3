"""``Model.loss`` and its gradients, the port against the JAX reference:
the training slice's vlm (qwen2-vl-2b), the reference test's
arch (phi4-mini-3.8b) and MLA with MoE (deepseek-v3-671b, ``lb_loss``).

Both models get the same weights (the port's init, carried to the
reference key for key) and the same batch (the reference's
``make_batch``, step 1): the loss within 1e-5 (relative), the scalar aux
(MoE's ``lb_loss``) too, and each gradient leaf within 1e-4 of its
largest |g|, in float32; remat on gives the port the same loss and
gradients as remat off. The port's gradients run through
``FlashAttentionFn``'s plain backward on the CPU; the card's kernel is
held against that in ``tests/test_torch_cuda.py``. The helpers are
``tests/_train_grads.py``'s."""
import pytest

from _train_grads import arch_case, check_loss_and_grads, check_remat

ARCHS = {   # arch: SyntheticDataConfig batch / seq_len
    "qwen2-vl-2b": (2, 8),
    "phi4-mini-3.8b": (2, 12),
    "deepseek-v3-671b": (2, 10),
}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch_pair(request):
    return arch_case(request.param, ARCHS[request.param])


def test_loss_and_grads_match_reference(arch_pair):
    check_loss_and_grads(*arch_pair)


def test_remat_gives_the_same_loss_and_grads(arch_pair):
    check_remat(*arch_pair)
