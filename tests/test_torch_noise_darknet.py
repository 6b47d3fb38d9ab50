"""DarkNet-19's noisy integer stacks (paper §4.4) against the JAX reference.

The live stand-in stacks of ``test_torch_darknet.py`` (int8 and their
ternary twins) at 16x16 (reduced) and 64x64 (full width), carried into the
port bit for bit, serve noisy requests with the same key on both sides:
the reference through ``impl="im2col"``, the port through its fused conv +
pool path, from the same entry codes. Each side's logits are its own FP
tail (decode, 1x1 head, spatial mean) over its noisy codes, so each noisy
core runs once per side; the tail itself is held against the reference in
``test_torch_darknet.py``, and noisy ``int_apply`` end to end (the reduced
stack) there too. Tolerances as in ``test_torch_noise.py``: ``int_core``
codes equal, counted, failed above a fraction of 1e-4; logits within
1e-4 x max|logit|, the clean DarkNet tests' tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_darknet as dnt
from repro.core import fq_layers as jfql
from repro.core import integer_inference as jii
from repro.core import noise as jnoise
from repro.core.quant import QuantConfig as JQuantConfig, RELU_BOUND
from repro.models import darknet as jdn
from repro_torch import interop
from repro_torch.core import fq_layers as tfql
from repro_torch.core import integer_inference as tii
from repro_torch.core.quant import QuantConfig
from repro_torch.models import darknet as tdn
from test_torch_noise import CONDITIONS, _t, codes_flips, port_noise


def _ref_logits(ip, codes):
    """The reference int_apply's tail over integer-core codes."""
    h = jii.decode_output(jnp.asarray(codes), ip["s_out_last"],
                          dnt.JQCFG.bits_out)
    h = jfql.fq_conv2d(ip["head"], h, JQuantConfig(), padding="SAME",
                       b_in=RELU_BOUND)
    return np.asarray(jnp.mean(h, axis=(1, 2)))


def _port_logits(st, codes):
    """The port int_apply's tail over integer-core codes."""
    h = tii.decode_output(codes, st["s_out_last"], dnt.QCFG.bits_out)
    h = tfql.fq_conv2d(st["head"], h, QuantConfig(), padding="SAME",
                       b_in=RELU_BOUND)
    return torch.mean(h, dim=(1, 2))


def _dn_stacks(name, fmt):
    if fmt == "int8":
        return dnt._reference(name)[2], dnt._carried(name)
    return dnt._ternary(name)


@pytest.mark.parametrize("name", list(dnt.CFGS))
@pytest.mark.parametrize("fmt", ["int8", "ternary"])
@pytest.mark.parametrize("cond", list(CONDITIONS))
@pytest.mark.parametrize("chunks", [1, 4])
def test_darknet_noisy_stack_matches_reference(name, fmt, cond, chunks):
    """The live stand-in at 16x16 (reduced) and 64x64 (full width), the
    fused pool on the port's side against the reference's im2col."""
    ip, st = _dn_stacks(name, fmt)
    jcfg, tcfg, _, _ = dnt.CFGS[name]
    noise = jnoise.TABLE7_CONDITIONS[CONDITIONS[cond]]
    jk = jax.random.PRNGKey(9)
    tk = interop.key_from_numpy(np.asarray(jk), device="cpu")
    codes = jii.entry_codes(
        dnt._ref_pre_entry(ip["conv0"], dnt._images(name), jcfg),
        ip["entry"], dnt.JQCFG, b_in=RELU_BOUND)
    kw = dict(mac_chunks=chunks)
    want = np.asarray(jdn.int_core(ip, codes, dnt.JQCFG, jcfg, impl="im2col",
                                   noise=noise, rng=jk, **kw))
    got = tdn.int_core(st, _t(codes), dnt.QCFG, tcfg, impl="fused",
                       noise=port_noise(noise), rng=tk, **kw)
    codes_flips(got, want, f"darknet {name} {fmt}")
    assert (want != dnt._ref_core(name)).any(), "the noise moved no code"
    want = _ref_logits(ip, want)
    np.testing.assert_allclose(_port_logits(st, got).numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
