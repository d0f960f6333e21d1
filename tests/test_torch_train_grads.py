"""Port vs reference: ``backward='approx'`` — both gradient products of
every emulated linear on the SIMDive multiplier — through the training
loss of all ten smoke configurations, against
``jax.value_and_grad(lm.train_loss)``.

The same inputs, helpers and stated tolerances as
``test_torch_loss.py`` (split off so that each file's reference compiles
stay near a minute of one worker): the loss, the logits and every
gradient leaf, and R-8 (the SIMDive divider leaves the attention branch
upstream of the finalize without a gradient, zero in the reference,
``None`` in the port).
"""
import pytest
import torch

from repro_torch.configs import ARCHS
from test_torch_loss import check_against_reference, check_r8

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ARCHS)
def test_approx_backward_loss_logits_and_grads_match_reference(arch):
    check_against_reference(arch, "approx_backward")


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-2.7b"])
def test_r8_holds_under_the_approximate_backward(arch):
    # the exact side is held in test_torch_loss.py
    check_r8(arch, "approx_backward", against_exact=False)
