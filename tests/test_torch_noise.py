"""The §4.4 noise model of repro_torch against the JAX reference.

Inputs are made with numpy from fixed seeds and handed to both packages; the
port runs on ``device="cpu"``, through the plain versions of the kernels.
The reference runs its kernels as its own tests run them on the CPU:
``fq_matmul`` in interpret mode, convs through ``impl="im2col"`` (its fused
Pallas conv does not trace on current jax). Under noise, a dequant output
is also held against the reference's op-by-op oracle
(``repro.kernels.ref.ref_fq_matmul``, eager, over its own im2col patches):
jitted, XLA contracts the noisy epilogue's add and multiply into a fused
multiply-add, so the interpret-mode kernel's dequant values differ from
the unfused float32 arithmetic by one ulp in ~2% of the outputs. The port
and its CUDA kernels (built with --fmad=false) compute the unfused one.

Tolerances:
  * threefry keys, bits, seeds and uniforms: bit-exact;
  * normals: atol 1e-6 (the port's erfinv is XLA's polynomial, but torch's
    log1p and sums round differently: measured at most 4.8e-7);
  * the ADC-noise field and every noisy op given the same operands, sigma
    and seed: bit-exact (dequant: against the eager oracle; within 1e-6 x
    max|y| of the jitted kernel, see above);
  * codes that go through normal draws (``perturb_codes``, a noisy
    ``int_core``): equal, counted, and failed above a fraction of 1e-4 of
    the codes (a draw that differs by an ulp right at a rounding boundary
    can flip one); the count is named in the message;
  * logits: the tolerances of the clean serving tests (KWS atol 1e-5,
    DarkNet 1e-4 x max|logit|).

The stack-level tests reuse the reference stacks of ``test_torch_kws.py``
and ``test_torch_darknet.py``, and the code that builds them; DarkNet's
noisy stacks are held in ``test_torch_noise_darknet.py``, a file of their
own so that the two slow stand-ins are built on two test workers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_darknet as dnt
import test_torch_kws as kwt
from repro.core import integer_inference as jii
from repro.core import noise as jnoise
from repro.core.quant import RELU_BOUND
from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import kws as jkws
from repro_torch import interop
from repro_torch import kernels as tkernels
from repro_torch.core import noise as tnoise
from repro_torch.core import prng
from repro_torch.core import quant as tq
from repro_torch.kernels import ops as tops
from repro_torch.models import darknet as tdn
from repro_torch.models import kws as tkws

SEEDS = [0, 5, 2 ** 31 + 3, -1]
FORMATS = ["int8", "int4", "ternary"]
MAX_FLIP_FRACTION = 1e-4
CONDITIONS = {"first": 0, "last": -1}


def _u32(a):
    return np.asarray(a).astype(np.int64)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def port_noise(cfg):
    return tnoise.NoiseConfig(cfg.sigma_w, cfg.sigma_a, cfg.sigma_mac)


# ---------------------------------------------------------------------------
# threefry, keys, uniforms, normals
# ---------------------------------------------------------------------------


def test_reference_values_of_the_smoke_run():
    """The two values chip_smoke.py checks on the card (it has no jax)."""
    keys = prng.split(prng.PRNGKey(5), 3)
    assert keys[0].tolist() == [2724472204, 3573582090]
    assert int(tnoise.derive_seed(keys[2])) == 4107458132
    k = jax.random.split(jax.random.PRNGKey(5), 3)
    assert _u32(k[0]).tolist() == [2724472204, 3573582090]
    assert int(jnoise.derive_seed(k[2])) == 4107458132


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_bits_bit_exact(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert tk.tolist() == _u32(jk).tolist()
    for n in (3, 7, 17):
        np.testing.assert_array_equal(prng.split(tk, n).numpy(),
                                      _u32(jax.random.split(jk, n)))
    for data in (0, 7, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(),
                                      _u32(jax.random.fold_in(jk, data)))
    for shape in [(), (5,), (3, 4), (2, 3, 5)]:
        np.testing.assert_array_equal(
            prng.bits(tk, shape).numpy(),
            _u32(jax.random.bits(jk, shape, jnp.uint32)))
    for k_j, k_t in zip(jax.random.split(jk, 3), prng.split(tk, 3)):
        seed_t = tnoise.derive_seed(k_t)
        assert seed_t.dtype == torch.uint32 and seed_t.dim() == 0
        assert int(seed_t) == int(jnoise.derive_seed(k_j))


def test_typed_and_legacy_keys_carried_across():
    for jk in (jax.random.key(11), jax.random.PRNGKey(11)):
        tk = interop.key_from_numpy(np.asarray(jax.random.key_data(jk)),
                                    device="cpu")
        assert tk.dtype == torch.int64 and tk.tolist() == [0, 11]
        np.testing.assert_array_equal(
            prng.split(tk, 4).numpy(),
            _u32(jax.random.key_data(jax.random.split(jk, 4))))
    with pytest.raises(ValueError):
        interop.key_from_numpy(np.zeros(3, np.uint32), device="cpu")
    with pytest.raises(ValueError):
        prng.split(torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_exact_normal_within_atol(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = np.asarray(jax.random.uniform(jk, (100_000,)))
    got = prng.uniform(tk, 100_000).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    want = np.asarray(jax.random.uniform(jk, (100_000,), jnp.float32, lo, 1))
    got = prng.uniform(tk, 100_000, float(lo), 1.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    want = np.asarray(jax.random.normal(jk, (100_000,)))
    got = prng.normal(tk, 100_000).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the ADC-noise field
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 4107458132, 2 ** 31 + 7])
@pytest.mark.parametrize("chunks", [1, 4])
def test_field_bit_exact(seed, chunks):
    rng = np.random.default_rng(seed % 1000)
    idx = np.concatenate([np.arange(100_000),
                          rng.integers(0, 2 ** 32, 100_000)]).astype(np.int64)
    j_idx = jnp.asarray(idx.astype(np.uint32))
    t_idx = torch.from_numpy(idx)
    np.testing.assert_array_equal(tnoise.hash_u32(t_idx).numpy(),
                                  _u32(jnoise.hash_u32(j_idx)))
    want = np.asarray(jnoise.unit_normal_field(j_idx, jnp.uint32(seed),
                                               salt=chunks))
    got = tnoise.unit_normal_field(t_idx, seed, salt=chunks).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    sigma = np.float32(0.37 * (chunks + 2))
    want = np.asarray(jnoise.mac_noise_field(j_idx, jnp.uint32(seed),
                                             jnp.float32(sigma),
                                             chunks=chunks))
    got = tnoise.mac_noise_field(t_idx, torch.tensor(seed, dtype=torch.uint32),
                                 torch.tensor(sigma), chunks=chunks).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_field_std_is_sigma_over_sqrt_chunks(chunks):
    """The port's twin of the reference's calibration tests: std sigma /
    sqrt(K), mean ~0, support within 6 sigma."""
    sigma = 10.0
    idx = torch.arange(50_000, dtype=torch.int64)
    f = np.concatenate([tnoise.mac_noise_field(
        idx, s, torch.tensor(sigma), chunks=chunks).numpy()
        for s in (3, 4)]).astype(np.float64)
    assert abs(f.mean()) < 4 * sigma / np.sqrt(f.size)
    np.testing.assert_allclose(f.std(), sigma / np.sqrt(chunks), rtol=0.02)
    assert np.abs(f).max() <= 6.0 * sigma + 1e-3


def test_mac_chunks_below_one_refused():
    with pytest.raises(ValueError):
        tnoise.mac_noise_field(torch.arange(4), 1, torch.tensor(1.0),
                               chunks=0)


# ---------------------------------------------------------------------------
# code-domain perturbation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [0.01, 0.3, 1.5])
@pytest.mark.parametrize("lo,hi", [(0, 7), (-1, 1), (-127, 127)])
def test_perturb_codes_equal_counted(sigma, lo, hi):
    rng = np.random.default_rng(int(sigma * 100) + hi)
    codes = rng.integers(lo, hi + 1, (300, 700)).astype(np.int8)
    jk = jax.random.PRNGKey(hi + 3)
    want = np.asarray(jnoise.perturb_codes(jnp.asarray(codes), jk, sigma,
                                           lo=lo, hi=hi))
    got = tnoise.perturb_codes(_t(codes), interop.key_from_numpy(
        np.asarray(jk), device="cpu"), sigma, lo=lo, hi=hi)
    assert got.dtype == torch.int8
    flips = int((got.numpy() != want).sum())
    assert flips <= MAX_FLIP_FRACTION * codes.size, (
        f"{flips} of {codes.size} perturbed codes differ")
    assert (want != codes).any() or sigma < 0.1
    assert tnoise.perturb_codes(_t(codes), None, sigma, lo=lo, hi=hi) \
        .numpy().tobytes() == codes.tobytes()


# ---------------------------------------------------------------------------
# noisy ops, given the same operands, sigma and seed: bit-exact
# ---------------------------------------------------------------------------


def _noise_args(rng, scale):
    """sigma_acc ~ 0.6 output LSB in accumulator units, and a seed."""
    sigma = np.float32(0.6 / scale)
    seed = int(rng.integers(0, 2 ** 32))
    return ((dict(noise_sigma_acc=jnp.float32(sigma),
                  noise_seed=jnp.uint32(seed))),
            dict(noise_sigma_acc=torch.tensor(sigma),
                 noise_seed=torch.tensor(seed, dtype=torch.uint32)))


def _weights(rng, rows, cols, fmt, taps=None):
    r = tq.format_range(fmt)
    w = rng.integers(-r, r + 1, (rows, cols)).astype(np.int8)
    if fmt == "int8":
        return w
    t = torch.from_numpy(w)
    packed = (tq.pack_codes(t, fmt) if taps is None
              else tq.pack_im2col_codes(t, taps, fmt))
    return packed.numpy()


def _eager_oracle(patches, w, scale, jn, *, taps, fmt, **kw):
    """The reference's op-by-op noisy GEMM over its im2col patches (2-D or
    with leading dims), weights unpacked to int8 as its im2col impl does."""
    w = jnp.asarray(w)
    if fmt != "int8":
        w = jq.unpack_im2col_codes(w, taps, patches.shape[-1] // taps, fmt)
    flat = patches.reshape(-1, patches.shape[-1])
    y = jref.ref_fq_matmul(flat, w, jnp.float32(scale), **jn, **kw)
    return np.asarray(y).reshape(*patches.shape[:-1], -1)


def _assert_matches(got, kernel, eager, epilogue):
    """Bit-exact with the eager oracle; with the jitted kernel too for
    codes, and within 1e-6 x max|y| for dequant values (XLA's FMA)."""
    np.testing.assert_array_equal(got.numpy(), eager)
    if epilogue == "requant":
        np.testing.assert_array_equal(got.numpy(), kernel)
    else:
        np.testing.assert_allclose(got.numpy(), kernel, rtol=0,
                                   atol=1e-6 * np.abs(kernel).max())


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("epilogue,lo", [("requant", -7), ("dequant", 0)])
def test_int_matmul_noisy_bit_exact(fmt, chunks, epilogue, lo):
    rng = np.random.default_rng(len(fmt) * 10 + chunks)
    m, k, n = 150, 135, 45            # no dim a multiple of a tile
    a = rng.integers(-7, 8, (m, k)).astype(np.int8)
    b = _weights(rng, k, n, fmt)
    scale = np.float32(0.013)
    jn, tn = _noise_args(rng, scale)
    kw = dict(epilogue=epilogue, n_out=7, lo=lo, mac_chunks=chunks,
              weight_format=fmt)
    want = np.asarray(jops.int_matmul(jnp.asarray(a), jnp.asarray(b),
                                      jnp.float32(scale), **jn, **kw))
    b8 = jq.unpack_codes(jnp.asarray(b), fmt, rows=k)
    eager = np.asarray(jref.ref_fq_matmul(
        jnp.asarray(a), b8, jnp.float32(scale), epilogue=epilogue, n_out=7,
        lo=lo, mac_chunks=chunks, **jn))
    got = tops.int_matmul(_t(a), _t(b), torch.tensor(scale), **tn, **kw)
    _assert_matches(got, want, eager, epilogue)
    clean = tops.int_matmul(_t(a), _t(b), torch.tensor(scale),
                            epilogue=epilogue, n_out=7, lo=lo,
                            weight_format=fmt)
    assert not torch.equal(got, clean), "the noise moved nothing"


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("dilation,epilogue", [(1, "requant"),
                                               (8, "dequant"),
                                               (32, "requant")])
def test_fq_conv1d_noisy_bit_exact(fmt, chunks, dilation, epilogue):
    rng = np.random.default_rng(dilation + chunks)
    cin = 45
    a = rng.integers(0, 8, (2, 70, cin)).astype(np.int8)
    w = _weights(rng, 3 * cin, 45, fmt, taps=3)
    scale = np.float32(0.021)
    jn, tn = _noise_args(rng, scale)
    kw = dict(ksize=3, dilation=dilation, epilogue=epilogue, n_out=7, lo=0,
              mac_chunks=chunks, weight_format=fmt)
    want = np.asarray(jops.fq_conv1d_int(jnp.asarray(a), jnp.asarray(w),
                                         jnp.float32(scale), impl="im2col",
                                         **jn, **kw))
    patches, _ = jops._im2col_1d(jnp.asarray(a), 3, dilation)
    eager = _eager_oracle(patches, w, scale, jn, taps=3, fmt=fmt,
                          epilogue=epilogue, n_out=7, lo=0,
                          mac_chunks=chunks)
    for impl in ("fused", "im2col"):
        got = tops.fq_conv1d_int(_t(a), _t(w), torch.tensor(scale),
                                 impl=impl, **tn, **kw)
        _assert_matches(got, want, eager, epilogue)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("epilogue,lo", [("requant", -7), ("dequant", 0)])
def test_fq_conv2d_noisy_bit_exact(fmt, chunks, epilogue, lo):
    """Padding, stride 2 and a ragged cin (5: packed weights pad it per
    tap, and the perturbed pad lanes must stay inert)."""
    rng = np.random.default_rng(len(fmt) + chunks * 7)
    cin = 5
    a = rng.integers(0, 8, (2, 11, 13, cin)).astype(np.int8)
    w = _weights(rng, 9 * cin, 19, fmt, taps=9)
    scale = np.float32(0.05)
    jn, tn = _noise_args(rng, scale)
    kw = dict(ksize=3, stride=2, padding=1, epilogue=epilogue, n_out=7,
              lo=lo, mac_chunks=chunks, weight_format=fmt)
    want = np.asarray(jops.fq_conv2d_int(jnp.asarray(a), jnp.asarray(w),
                                         jnp.float32(scale), impl="im2col",
                                         **jn, **kw))
    patches = jops._im2col_2d(jnp.asarray(a), 3, 2, 1)[0]
    eager = _eager_oracle(patches, w, scale, jn, taps=9, fmt=fmt,
                          epilogue=epilogue, n_out=7, lo=lo,
                          mac_chunks=chunks)
    for impl in ("fused", "im2col"):
        got = tops.fq_conv2d_int(_t(a), _t(w), torch.tensor(scale),
                                 impl=impl, **tn, **kw)
        _assert_matches(got, want, eager, epilogue)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("pool", [2, 3])
def test_fq_conv2d_pool_noisy_bit_exact(fmt, chunks, pool):
    """The pool runs on the noisy pre-pool accumulator; odd Ho / Wo drop
    their last rows and columns."""
    rng = np.random.default_rng(len(fmt) + chunks + pool)
    cin = 6
    a = rng.integers(0, 8, (2, 13, 15, cin)).astype(np.int8)
    w = _weights(rng, 9 * cin, 21, fmt, taps=9)
    scale = np.float32(0.05)
    jn, tn = _noise_args(rng, scale)
    kw = dict(ksize=3, padding=1, pool=pool, n_out=7, lo=0,
              mac_chunks=chunks, weight_format=fmt)
    want = np.asarray(jops.fq_conv2d_pool_int(
        jnp.asarray(a), jnp.asarray(w), jnp.float32(scale), impl="im2col",
        **jn, **kw))
    for impl in ("fused", "im2col"):
        got = tops.fq_conv2d_pool_int(_t(a), _t(w), torch.tensor(scale),
                                      impl=impl, **tn, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


def test_noise_operands_refused_and_counted():
    """A sigma needs a seed (the reference asserts it), mac_chunks >= 1;
    the CPU path launches no kernel, noisy or not."""
    a = torch.zeros(4, 12, dtype=torch.int8)
    w = torch.zeros(12, 3, dtype=torch.int8)
    s = torch.tensor(0.1)
    sig = torch.tensor(1.0)
    seed = torch.tensor(3, dtype=torch.uint32)
    with pytest.raises(ValueError, match="noise_seed"):
        tops.int_matmul(a, w, s, noise_sigma_acc=sig)
    with pytest.raises(ValueError, match="mac_chunks"):
        tops.int_matmul(a, w, s, noise_sigma_acc=sig, noise_seed=seed,
                        mac_chunks=0)
    with pytest.raises(ValueError, match="noise_seed"):
        tops.fq_conv2d_pool_int(a.reshape(1, 2, 2, 12), w.repeat(9, 1), s,
                                ksize=3, padding=1, impl="fused",
                                noise_sigma_acc=sig)
    tkernels.reset_launch_counts()
    tops.fq_conv1d_int(a.reshape(1, 4, 12), w.repeat(3, 1), s, ksize=3,
                       impl="fused", noise_sigma_acc=sig, noise_seed=seed)
    assert tkernels.noisy_launch_counts() == {
        "fq_matmul_noisy": 0, "fq_conv2d_noisy": 0,
        "fq_conv2d_pool_noisy": 0}


# ---------------------------------------------------------------------------
# stacks: noisy int_core and logits against the reference
# ---------------------------------------------------------------------------


def _kws_stacks(name, fmt):
    if fmt == "int8":
        return kwt._reference(name)[2], kwt._carried(name)
    return kwt._ternary(name)


def codes_flips(got, want, what):
    flips = int((got.numpy() != np.asarray(want)).sum())
    assert got.shape == want.shape
    assert flips <= MAX_FLIP_FRACTION * want.size, (
        f"{what}: {flips} of {want.size} codes differ")
    return flips


@pytest.mark.parametrize("name", list(kwt.CFGS))
@pytest.mark.parametrize("fmt", ["int8", "ternary"])
@pytest.mark.parametrize("cond", list(CONDITIONS))
@pytest.mark.parametrize("chunks", [1, 4])
def test_kws_noisy_stack_matches_reference(name, fmt, cond, chunks):
    ip, st = _kws_stacks(name, fmt)
    jcfg, tcfg, _ = kwt.CFGS[name]
    noise = jnoise.TABLE7_CONDITIONS[CONDITIONS[cond]]
    jk = jax.random.PRNGKey(5)
    tk = interop.key_from_numpy(np.asarray(jk), device="cpu")
    x = kwt._inputs(name)[:2]
    codes = jii.entry_codes(kwt._ref_h(ip, x), ip["entry"], kwt.JQCFG,
                            b_in=RELU_BOUND)
    kw = dict(mac_chunks=chunks)
    want = np.asarray(jkws.int_core(ip, codes, kwt.JQCFG, jcfg,
                                    impl="im2col", noise=noise, rng=jk, **kw))
    got = tkws.int_core(st, _t(codes), kwt.QCFG, tcfg, noise=port_noise(
        noise), rng=tk, **kw)
    codes_flips(got, want, f"kws {name} {fmt}")
    clean = np.asarray(jkws.int_core(ip, codes, kwt.JQCFG, jcfg,
                                     impl="im2col"))
    assert (want != clean).any(), "the noise moved no code"
    want = np.asarray(jkws.int_apply(ip, jnp.asarray(x), kwt.JQCFG, jcfg,
                                     impl="im2col", noise=noise, rng=jk,
                                     **kw))
    got = tkws.int_apply(st, _t(x), kwt.QCFG, tcfg,
                         noise=port_noise(noise), rng=tk, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_full_kws_ternary_noise_differs_from_int8():
    """cin 45 pads to 48 per tap in a ternary stack and perturb_codes draws
    over the padded shape, so the ternary stack's noisy logits are not the
    int8 stack's, on either side; port and reference agree on each."""
    jcfg, tcfg, _ = kwt.CFGS["full"]
    noise = jnoise.TABLE7_CONDITIONS[-1]
    jk = jax.random.PRNGKey(5)
    tk = interop.key_from_numpy(np.asarray(jk), device="cpu")
    x = kwt._inputs("full")[:2]
    out = {}
    for fmt in ("int8", "ternary"):
        ip, st = _kws_stacks("full", fmt)
        want = np.asarray(jkws.int_apply(ip, jnp.asarray(x), kwt.JQCFG, jcfg,
                                         impl="im2col", noise=noise, rng=jk))
        got = tkws.int_apply(st, _t(x), kwt.QCFG, tcfg,
                             noise=port_noise(noise), rng=tk).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        out[fmt] = (want, got)
    assert not np.array_equal(out["int8"][0], out["ternary"][0])
    assert not np.array_equal(out["int8"][1], out["ternary"][1])


@pytest.mark.parametrize("model", ["kws", "darknet"])
def test_clean_path_unchanged(model):
    """noise=None, an all-zero NoiseConfig and rng=None each give the clean
    logits bit for bit, under every impl."""
    if model == "kws":
        st, tcfg, x, mod = (kwt._carried("reduced"), kwt.CFGS["reduced"][1],
                            _t(kwt._inputs("reduced")), tkws)
        qcfg = kwt.QCFG
    else:
        st, tcfg, x, mod = (dnt._carried("reduced"), dnt.CFGS["reduced"][1],
                            _t(dnt._images("reduced")), tdn)
        qcfg = dnt.QCFG
    key = prng.PRNGKey(3)
    for impl in ("fused", "im2col"):
        clean = mod.int_apply(st, x, qcfg, tcfg, impl=impl)
        for kw in (dict(noise=None, rng=key),
                   dict(noise=tnoise.NoiseConfig(), rng=key),
                   dict(noise=tnoise.TABLE7_CONDITIONS[-1], rng=None)):
            assert torch.equal(mod.int_apply(st, x, qcfg, tcfg, impl=impl,
                                             mac_chunks=4, **kw), clean)
