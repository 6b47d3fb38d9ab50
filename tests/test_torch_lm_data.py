"""The LM training data and gradient codes of the port against the reference.

``data.synthetic.make_bigram_stream`` / ``lm_batch`` and
``data.loader.SyntheticLMLoader.batch_at`` give the reference's tokens bit
for bit (at the smoke archs' vocabs and at minicpm-2b's 122,753);
``host_slice`` its slices; ``optim.grad_compress.q8_encode`` /
``q8_decode`` its codes and scales bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import loader as jloader
from repro.data import synthetic as jsyn
from repro.optim import grad_compress as jgc
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core import prng
from repro_torch.data import loader, synthetic
from repro_torch.optim import grad_compress


def _key(seed, step):
    return (jax.random.fold_in(jax.random.key(seed), step),
            prng.fold_in(prng.PRNGKey(seed, device="cpu"), step))


@pytest.mark.parametrize("vocab,n,seq", [(509, 4, 16), (122753, 8, 256),
                                         (2, 3, 5), (64, 1, 1)])
def test_bigram_stream_bit_equal(vocab, n, seq):
    jk, tk = _key(0, 3)
    want = np.asarray(jsyn.make_bigram_stream(jk, n_seqs=n, seq_len=seq,
                                              vocab=vocab))
    got = synthetic.make_bigram_stream(tk, n_seqs=n, seq_len=seq,
                                       vocab=vocab)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, seq + 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bigram_stream_branch_and_table_seed():
    jk, tk = _key(5, 0)
    want = np.asarray(jsyn.make_bigram_stream(
        jk, n_seqs=2, seq_len=9, vocab=100, branch=7, table_seed=3))
    got = synthetic.make_bigram_stream(tk, n_seqs=2, seq_len=9, vocab=100,
                                       branch=7, table_seed=3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_loader_batches_bit_equal(arch_id):
    vocab = get_arch(arch_id).smoke.vocab
    jl = jloader.SyntheticLMLoader(jloader.LoaderConfig(4, 16, vocab, seed=2),
                                   jsyn.lm_batch)
    tl = loader.SyntheticLMLoader(loader.LoaderConfig(4, 16, vocab, seed=2),
                                  synthetic.lm_batch, device="cpu")
    for step in (0, 1, 7):
        jb, tb = jl.batch_at(step), tl.batch_at(step)
        assert sorted(tb) == ["labels", "tokens"]
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        np.testing.assert_array_equal(tb["tokens"][:, 1:].numpy(),
                                      tb["labels"][:, :-1].numpy())


def test_loader_full_vocab_and_iteration():
    cfg = (8, 256, 122753)
    jl = jloader.SyntheticLMLoader(jloader.LoaderConfig(*cfg), jsyn.lm_batch)
    tl = loader.SyntheticLMLoader(loader.LoaderConfig(*cfg),
                                  synthetic.lm_batch, device="cpu")
    for (i, tb), jb in zip(enumerate(tl), (jl.batch_at(0), jl.batch_at(1))):
        np.testing.assert_array_equal(tb["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))
        if i == 1:
            break


def test_batch_key_words():
    for seed, step in ((0, 0), (3, 17), (2 ** 31 - 1, 5)):
        want = np.asarray(jax.random.key_data(jloader.batch_key(seed, step)))
        got = loader.batch_key(seed, step, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("gb,n_hosts", [(8, 1), (8, 2), (12, 4), (7, 2)])
def test_host_slice(gb, n_hosts):
    for h in range(n_hosts):
        assert loader.host_slice(gb, h, n_hosts) == jloader.host_slice(
            gb, h, n_hosts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,scale", [((37, 5), 1.0), ((1000,), 1e-3),
                                         ((4, 4), 0.0), ((3,), 1e30)])
def test_q8_encode_decode_bit_equal(dtype, shape, scale):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jc, js = jgc.q8_encode(jx)
    tc, ts = grad_compress.q8_encode(tx)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(
        grad_compress.q8_decode(tc, ts).numpy(),
        np.asarray(jgc.q8_decode(jc, js)))
