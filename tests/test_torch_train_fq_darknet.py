"""Float FQ training of the port's DarkNet-19 against the JAX reference at
``reduced()``: ``darknet.apply(train=True)`` over the ladder's stages (FP,
Q ``QuantConfig(2, 5)``, FQ after ``to_fq`` + ``calibrate``, FQ under Table
7's noisiest condition), and the two points where PyTorch's own ops take
another gradient than the reference's: the max-pool's ties and the leaky
ReLU at 0. Helpers and tolerances: ``test_torch_train_fq.py`` and
``test_torch_fq_layers.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.models import darknet as tdn
from test_torch_train_fq import STAGES, check_stage


@pytest.mark.parametrize("stage", STAGES)
def test_darknet_apply_train_matches_reference(stage):
    check_stage("darknet", stage)


def test_darknet_pool_gradient_goes_to_the_first_maximum():
    """FQ codes tie often inside a 2x2 window: the reference's
    ``-reduce_window(-h, min)`` sends the gradient to the first maximum,
    and so does the port's pool (``amax`` would split it)."""
    h = np.array([[0.5, 0.5, 0.0, 0.0], [0.5, 0.25, 0.0, 0.0],
                  [1.0, 0.0, 0.75, 0.75], [0.0, 1.0, 0.75, 0.75]],
                 np.float32)[None, :, :, None]

    def ref(a):
        return jnp.sum(-jax.lax.reduce_window(-a, jnp.inf, jax.lax.min,
                                              (1, 2, 2, 1), (1, 2, 2, 1),
                                              "VALID") * jnp.arange(1., 5.)
                       .reshape(1, 2, 2, 1))
    want = np.asarray(jax.grad(ref)(jnp.asarray(h)))
    th = torch.from_numpy(h).requires_grad_(True)
    out = tops.maxpool2d(th)
    torch.sum(out * torch.arange(1., 5.).reshape(1, 2, 2, 1)).backward()
    np.testing.assert_array_equal(th.grad.numpy(), want)
    assert (want != 0).sum() == 4  # one position a window, ties included


def test_darknet_leaky_relu_gradient_at_zero():
    """jax.nn.leaky_relu's gradient at 0 is 1 (F.leaky_relu's is 0.1)."""
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    tdn._leaky_relu(x).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jax.nn.leaky_relu(a, 0.1)))(
        jnp.asarray([-1.0, 0.0, 2.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
