"""``repro_torch.models.transformer`` against the reference.

For the dense, VLM and encoder-decoder archs (codeqwen1.5-7b, minicpm-2b,
minitron-4b, llama3-405b, internvl2-1b, whisper-tiny; the MoE archs are in
``test_torch_moe_mla.py``, the recurrent ones in ``test_torch_recurrent.py``,
with the same checks), from the reference's params carried across by
``interop.params_from_numpy``, in float32 with the SMOKE
configs (``torch_zoo_ref``):

  * ``count_params`` / ``count_active_params`` equal;
  * ``forward`` logits, and ``prefill`` + 3 ``decode_step`` logits and
    caches, within 1e-4 x max|logit|, every quantizer code the port rounds
    otherwise a rounding tie (pinned to the reference's);
  * ``quantize_params_for_serving``: every leaf bit for bit.

For all ten archs at full size: the parameter and cache trees (``meta``)
leaf for leaf in name, shape and dtype, and the parameter counts. Beside
them: the int8 KV cache through a whole model, ``decode_step`` writing the
caches it is given, and bfloat16 params carried bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import transformer as JT
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import transformer as T

import torch_zoo_ref as Z
from torch_zoo_ref import one_thread  # noqa: F401 (autouse)

ARCHS = ["codeqwen1.5-7b", "minicpm-2b", "minitron-4b", "llama3-405b",
         "internvl2-1b", "whisper-tiny"]


@pytest.mark.parametrize("arch_id", ARCHS)
def test_arch_counts(arch_id):
    Z.check_counts(Z.arch_case(arch_id))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_arch_forward(arch_id):
    Z.check_forward(Z.arch_case(arch_id))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_arch_prefill_decode(arch_id):
    Z.check_prefill_decode(Z.arch_case(arch_id))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_arch_serving_codes(arch_id):
    Z.check_serving_codes(Z.arch_case(arch_id))


def _layout(jtree, ttree):
    jl = [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
          for p, a in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    tl = [(n, tuple(a.shape), str(a.dtype).replace("torch.", ""))
          for n, a in tree.named_leaves(ttree)]
    return [j[1:] for j in jl], [t[1:] for t in tl], len(jl), len(tl)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_full_size_structs(arch_id):
    """The full-size model's parameter tree and a decode cache tree (B=2,
    S=64) on ``meta``: the reference's leaves in order, shapes and dtypes;
    the parameter counts equal."""
    jm, m = jget_arch(arch_id).model, get_arch(arch_id).model
    assert T.count_params(m) == JT.count_params(jm)
    assert T.count_active_params(m) == JT.count_active_params(jm)
    ps = T.param_struct(m)
    assert all(x.is_meta for x in tree.leaves(ps))
    jl, tl, nj, nt = _layout(JT.param_struct(jm), ps)
    assert nj == nt and jl == tl
    jl, tl, nj, nt = _layout(JT.cache_struct(jm, 2, 64),
                             T.cache_struct(m, 2, 64))
    assert nj == nt and jl == tl


def test_kv_bits_8_through_the_model():
    """minitron's smoke config with the int8 KV cache: prefill + 3 decode
    steps against the reference's (codes at most 1 apart: K / V sum in
    other orders before they are quantized)."""
    c = Z.arch_case("minitron-4b")
    c8 = dataclasses.replace(
        c, jcfg=dataclasses.replace(c.jcfg, kv_bits=8),
        cfg=dataclasses.replace(c.cfg, kv_bits=8))
    Z.check_prefill_decode(c8)
    _, caches = T.prefill(c.params, {"tokens": c.batch["tokens"][:, :4]},
                          c8.cfg, c.q, max_len=8)
    k = caches["blocks"][0]["k"]
    assert k.dtype == torch.int8 and int(k.abs().max()) == 127
    assert caches["blocks"][0]["k_scale"].shape == (3, 2, 8, 2)


def test_decode_step_writes_caches_in_place():
    """decode_step returns the caches it was given, written: the same
    logits and caches as a step on a clone of them, the position moved."""
    c = Z.arch_case("codeqwen1.5-7b")
    toks = c.batch["tokens"]
    with torch.no_grad():
        _, caches = T.prefill(c.params, {"tokens": toks[:, :6]}, c.cfg, c.q,
                              max_len=10)
        before = tree.map(torch.clone, caches)
        l1, c1 = T.decode_step(c.params, before, toks[:, 6:7], c.cfg, c.q)
        l2, c2 = T.decode_step(c.params, caches, toks[:, 6:7], c.cfg, c.q)
        assert c1 is before and c2 is caches and torch.equal(l1, l2)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree.leaves(c1), tree.leaves(c2)))
        assert int(c2["blocks"][0]["pos"][0]) == 7


def test_bfloat16_params_carry_bit_for_bit():
    """A bfloat16 arch (the full configs' dtype), cut to the smoke widths:
    the reference's bf16 leaves arrive with the same bits, and the serving
    conversion's codes and scales are the reference's."""
    jcfg = dataclasses.replace(jget_arch("minitron-4b").smoke,
                               param_dtype=jnp.bfloat16)
    jp = JT.make_params(jax.random.key(3), jcfg)
    tp = Z.port_params(jp)
    assert tp["embed"]["w"].dtype == torch.bfloat16
    assert Z.tree_bits_equal(Z.to_np(jp), tp) == []
    assert Z.tree_bits_equal(Z.to_np(JT.quantize_params_for_serving(jp, 8)),
                             T.quantize_params_for_serving(tp, 8)) == []


def test_make_params_layout_and_device():
    cfg = get_arch("minitron-4b").smoke
    p = T.make_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert [tuple(x.shape) for x in tree.leaves(p)] == \
        [tuple(x.shape) for x in tree.leaves(T.param_struct(cfg))]
    assert p["blocks"][0]["attn"]["wq"]["s_w"].shape == (3,)
    c = T.init_caches(cfg, 2, 16, device="cpu")
    assert c["blocks"][0]["pos"].shape == (3,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.init_caches(cfg, 2, 16)
