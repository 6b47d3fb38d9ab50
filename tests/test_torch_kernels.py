"""K1-K3b of repro_torch against the JAX package's kernels and oracles.

Inputs are made with numpy from fixed seeds and handed to both packages.
The JAX side runs as its own tests run it on the CPU: the Pallas kernels in
interpret mode, plus the pure-jnp oracles in ``repro.kernels.ref``. Convs
are held against ``repro.kernels.ops.fq_conv*_int(impl="im2col")`` (and
the conv + max-pool against ``fq_conv2d_pool_int(impl="im2col")``), the
reference's declared parity oracle (its fused Pallas conv does not trace on
current jax). The port runs on ``device="cpu"``, where each wrapper takes
its plain PyTorch version. Every compare is bit-exact: int8 codes, and f32
dequant values, which are one float32 product of the same int32 and scale.

The CUDA kernels are held against these plain versions on the card in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fq_matmul import fq_matmul as j_fq_matmul
from repro.kernels.quantize import quantize_codes as j_quantize_codes
from repro_torch import kernels as tkernels
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fq_conv import fq_conv1d, fq_conv2d
from repro_torch.kernels.fq_matmul import fq_matmul
from repro_torch.kernels.quantize import quantize_codes

KWS_DILATIONS = (1, 1, 2, 4, 8, 16, 32)


def _codes(rng, shape, lo, hi):
    return rng.integers(lo, hi + 1, size=shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# K1 quantize_codes
# ---------------------------------------------------------------------------


def _half_lsb_ties(n: int) -> np.ndarray:
    """float32 u with f32(u * n) exactly k + 0.5 for every level k."""
    out = []
    for k in range(-n, n):
        target = np.float32(k + 0.5)
        u = np.float32(target / np.float32(n))
        for _ in range(8):
            if np.float32(u * np.float32(n)) == target:
                out.append(u)
                break
            u = np.nextafter(u, np.float32(np.inf) if u * n < target
                             else np.float32(-np.inf), dtype=np.float32)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("rows,cols", [(8, 16), (300, 39), (4 * 140, 100)])
@pytest.mark.parametrize("bits,b", [(4, 0.0), (8, -1.0), (2, -1.0)])
def test_quantize_codes_bit_exact(rows, cols, bits, b):
    n = 2 ** (bits - 1) - 1
    rng = np.random.default_rng(rows * 31 + cols + bits)
    x = (rng.standard_normal((rows, cols)) * 2).astype(np.float32)
    s = np.float32(0.43)
    inv = np.asarray(jnp.exp(-jnp.float32(s)))
    want_k = np.asarray(j_quantize_codes(jnp.asarray(x), jnp.asarray(inv),
                                         n=n, b=b, interpret=True))
    want_r = np.asarray(jref.ref_quantize_codes(jnp.asarray(x),
                                                jnp.asarray(inv), n=n, b=b))
    got = quantize_codes(_t(x), _t(inv), n=n, b=b)
    assert got.dtype == torch.int8 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want_k)
    np.testing.assert_array_equal(got.numpy(), want_r)


@pytest.mark.parametrize("bits", [2, 4, 5, 8])
@pytest.mark.parametrize("inv", [1.0, 0.5])
def test_quantize_codes_half_lsb_ties(bits, inv):
    """Values exactly on a half LSB round half to even, as jnp.round."""
    n = 2 ** (bits - 1) - 1
    u = _half_lsb_ties(n)
    assert len(u) == 2 * n
    x = (u / np.float32(inv)).astype(np.float32).reshape(1, -1)
    inv32 = np.float32(inv)
    want = np.asarray(j_quantize_codes(jnp.asarray(x), jnp.float32(inv32),
                                       n=n, b=-1.0, interpret=True))
    got = quantize_codes(_t(x), torch.tensor(inv32), n=n, b=-1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy().astype(int) % 2 == 0).all()  # ties went to even


# ---------------------------------------------------------------------------
# K2 fq_matmul
# ---------------------------------------------------------------------------


MATMUL_SHAPES = [(37, 13, 5), (130, 257, 129), (1, 64, 64), (64, 64, 64),
                 (4 * 138, 300, 45), (4 * 12, 135, 45)]


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("epilogue,lo", [("requant", 0), ("requant", -7),
                                         ("dequant", 0)])
def test_fq_matmul_bit_exact(m, k, n, epilogue, lo):
    rng = np.random.default_rng(m * 7 + k * 3 + n)
    a = _codes(rng, (m, k), 0, 7)
    b = _codes(rng, (k, n), -1, 1)
    scale = np.float32(0.0371)
    kw = dict(epilogue=epilogue, n_out=7, lo=lo)
    want_k = np.asarray(j_fq_matmul(jnp.asarray(a), jnp.asarray(b),
                                    jnp.float32(scale), interpret=True, **kw))
    want_r = np.asarray(jref.ref_fq_matmul(jnp.asarray(a), jnp.asarray(b),
                                           jnp.float32(scale), **kw))
    got = fq_matmul(_t(a), _t(b), torch.tensor(scale), **kw)
    assert got.dtype == (torch.int8 if epilogue == "requant"
                         else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want_k)
    np.testing.assert_array_equal(got.numpy(), want_r)


@pytest.mark.parametrize("lo", [0, -15])
def test_fq_matmul_epilogue_ties_and_clip(lo):
    """scale 0.5 on odd accumulators puts every output on a half: round
    half to even and the clip to [lo, n_out] must match the reference."""
    rng = np.random.default_rng(5)
    a = _codes(rng, (96, 77), -15, 15)
    b = _codes(rng, (77, 33), -7, 7)
    scale = np.float32(0.5)
    kw = dict(epilogue="requant", n_out=15, lo=lo)
    want = np.asarray(j_fq_matmul(jnp.asarray(a), jnp.asarray(b),
                                  jnp.float32(scale), interpret=True, **kw))
    got = fq_matmul(_t(a), _t(b), torch.tensor(scale), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    acc = a.astype(np.int64) @ b.astype(np.int64)
    assert (acc % 2 == 1).any() and (np.abs(acc) > 2 * 15).any()


def test_int_accumulate_exact_at_int8_extremes():
    rng = np.random.default_rng(3)
    a = _codes(rng, (64, 2048), -127, 127)
    b = _codes(rng, (2048, 32), -127, 127)
    acc = tref.int_accumulate(_t(a), _t(b))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


# ---------------------------------------------------------------------------
# K3 fq_conv (fused) and the im2col impl
# ---------------------------------------------------------------------------


def _kws_layer_shapes():
    """(t_in, cin, dilation) of the seven full-width KWS layers."""
    t, cin, out = 140, 100, []
    for d in KWS_DILATIONS:
        out.append((t, cin, d))
        t, cin = t - 2 * d, 45
    return out


@pytest.mark.parametrize("t,cin,dil", _kws_layer_shapes())
def test_fq_conv1d_kws_layers_bit_exact(t, cin, dil):
    rng = np.random.default_rng(t * 10 + dil)
    a = _codes(rng, (2, t, cin), 0, 7)
    w = _codes(rng, (3 * cin, 45), -1, 1)
    scale = np.float32(0.0213)
    want = np.asarray(jops.fq_conv1d_int(
        jnp.asarray(a), jnp.asarray(w), jnp.float32(scale), ksize=3,
        dilation=dil, n_out=7, lo=0, impl="im2col"))
    ta, tw, ts = _t(a), _t(w), torch.tensor(scale)
    fused = tops.fq_conv1d_int(ta, tw, ts, ksize=3, dilation=dil, n_out=7,
                               lo=0, impl="fused")
    im2col = tops.fq_conv1d_int(ta, tw, ts, ksize=3, dilation=dil, n_out=7,
                                lo=0, impl="im2col")
    assert fused.shape == (2, t - 2 * dil, 45) and fused.dtype == torch.int8
    np.testing.assert_array_equal(fused.numpy(), want)
    np.testing.assert_array_equal(im2col.numpy(), want)


@pytest.mark.parametrize("ksize,stride,padding,dilation", [
    (3, 2, 1, 1), (3, 1, 1, 2), (3, 2, 1, 2), (1, 1, 0, 1), (3, 1, 0, 1)])
@pytest.mark.parametrize("epilogue,lo", [("requant", 0), ("requant", -7),
                                         ("dequant", 0)])
def test_fq_conv2d_bit_exact(ksize, stride, padding, dilation, epilogue, lo):
    rng = np.random.default_rng(ksize * 100 + stride * 10 + dilation)
    a = _codes(rng, (2, 9, 11, 6), 0, 7)
    w = _codes(rng, (ksize * ksize * 6, 10), -7, 7)
    scale = np.float32(0.047)
    kw = dict(ksize=ksize, stride=stride, padding=padding, dilation=dilation,
              epilogue=epilogue, n_out=7, lo=lo)
    want = np.asarray(jops.fq_conv2d_int(jnp.asarray(a), jnp.asarray(w),
                                         jnp.float32(scale), impl="im2col",
                                         **kw))
    ta, tw, ts = _t(a), _t(w), torch.tensor(scale)
    fused = tops.fq_conv2d_int(ta, tw, ts, impl="fused", **kw)
    im2col = tops.fq_conv2d_int(ta, tw, ts, impl="im2col", **kw)
    np.testing.assert_array_equal(fused.numpy(), want)
    np.testing.assert_array_equal(im2col.numpy(), want)


# (B, H, W, Cin, Cout, ksize): DarkNet's four pooled layers at narrow
# widths, odd Ho / Wo, and a 1x1 conv
POOL_SHAPES = [(2, 16, 16, 4, 8, 3), (1, 12, 12, 8, 16, 3),
               (2, 13, 15, 6, 10, 3), (1, 9, 7, 5, 9, 1)]


@pytest.mark.parametrize("shape", POOL_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("pool", [2, 3])
@pytest.mark.parametrize("epilogue,lo", [("requant", 0), ("requant", -7),
                                         ("dequant", 0)])
def test_fq_conv2d_pool_bit_exact(shape, pool, epilogue, lo):
    """K3b's plain version (max of the int32 accumulator, then the
    epilogue) and the im2col + code-pool path against the reference's
    conv + reduce_window oracle."""
    b, h, w, cin, cout, ks = shape
    rng = np.random.default_rng(h * 100 + w * 10 + cin + pool)
    a = _codes(rng, (b, h, w, cin), 0, 7)
    wc = _codes(rng, (ks * ks * cin, cout), -7, 7)
    scale = np.float32(0.0131)
    kw = dict(ksize=ks, padding=ks // 2, pool=pool, epilogue=epilogue,
              n_out=7, lo=lo)
    want = np.asarray(jops.fq_conv2d_pool_int(
        jnp.asarray(a), jnp.asarray(wc), jnp.float32(scale), impl="im2col",
        **kw))
    ta, tw, ts = _t(a), _t(wc), torch.tensor(scale)
    plain = tref.ref_fq_conv2d(ta, tw, ts, kh=ks, kw=ks,
                               padding=(ks // 2, ks // 2), pool=(pool, pool),
                               epilogue=epilogue, n_out=7, lo=lo)
    fused = tops.fq_conv2d_pool_int(ta, tw, ts, impl="fused", **kw)
    im2col = tops.fq_conv2d_pool_int(ta, tw, ts, impl="im2col", **kw)
    assert plain.shape == (b, h // pool, w // pool, cout)
    assert plain.dtype == (torch.int8 if epilogue == "requant"
                           else torch.float32)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(fused.numpy(), want)
    np.testing.assert_array_equal(im2col.numpy(), want)


def test_fq_conv2d_pool_strided_dilated_non_square():
    """The fused wrapper takes any (ph, pw) on any conv; its plain version
    equals conv -> requant -> max-pool of the codes."""
    rng = np.random.default_rng(23)
    a = _t(_codes(rng, (2, 13, 15, 6), 0, 7))
    w = _t(_codes(rng, (9 * 6, 10), -7, 7))
    s = torch.tensor(np.float32(0.047))
    kw = dict(kh=3, kw=3, stride=(2, 2), padding=(1, 1), dilation=(2, 2),
              n_out=7, lo=-7)
    got = fq_conv2d(a, w, s, pool=(2, 3), **kw)
    conv = fq_conv2d(a, w, s, **kw)
    ho, wo = conv.shape[1:3]
    want = conv[:, :ho // 2 * 2, :wo // 3 * 3].reshape(
        2, ho // 2, 2, wo // 3, 3, 10).amax(dim=(2, 4))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="pool"):
        fq_conv2d(a, w, s, pool=(ho + 1, 1), **kw)


@pytest.mark.parametrize("hw,window,stride", [((9, 11), 2, 2), ((7, 7), 3, 3),
                                              ((8, 5), 3, 2), ((4, 6), 1, 1)])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_maxpool2d_bit_exact(hw, window, stride, dtype):
    rng = np.random.default_rng(hw[0] * 10 + hw[1] + window)
    if dtype == "int8":
        y = _codes(rng, (2, *hw, 5), -7, 7)
    else:
        y = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    want = np.asarray(jops.maxpool2d(jnp.asarray(y), window=window,
                                     stride=stride))
    got = tops.maxpool2d(_t(y), window=window, stride=stride)
    assert got.dtype == _t(y).dtype and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_fq_conv1d_dequant_bit_exact():
    rng = np.random.default_rng(11)
    a = _codes(rng, (3, 20, 5), 0, 7)
    w = _codes(rng, (3 * 5, 4), -1, 1)
    scale = np.float32(0.0123)
    want = np.asarray(jops.fq_conv1d_int(
        jnp.asarray(a), jnp.asarray(w), jnp.float32(scale), ksize=3,
        dilation=2, epilogue="dequant", impl="im2col"))
    got = fq_conv1d(_t(a), _t(w), torch.tensor(scale), ksize=3, dilation=2,
                    epilogue="dequant")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Dispatch, refusals, launch counters
# ---------------------------------------------------------------------------


def test_conv_impl_dispatch():
    assert tops.conv_impl(None, torch.device("cpu")) == "im2col"
    assert tops.conv_impl(None, torch.device("cuda")) == "fused"
    assert tops.conv_impl("fused", torch.device("cpu")) == "fused"
    with pytest.raises(ValueError):
        tops.conv_impl("xla")


def test_unported_options_refused_on_cpu():
    """Noise, once refused, now runs and equals the reference's im2col
    oracle (a sigma without a seed is refused, as the reference asserts);
    packed formats are accepted and give the int8 result, and an unknown
    format or a mismatched packed operand raises ValueError."""
    from repro_torch.core import quant as tq
    rng = np.random.default_rng(5)
    a = _t(_codes(rng, (2, 8, 4), 0, 7))
    w = _t(_codes(rng, (12, 3), -1, 1))
    s = torch.tensor(0.1)
    with pytest.raises(ValueError, match="noise_seed"):
        tops.fq_conv1d_int(a, w, s, ksize=3, noise_sigma_acc=0.5)
    with pytest.raises(ValueError, match="noise_seed"):
        tops.fq_conv2d_pool_int(a.unsqueeze(2), w[:4], s, ksize=1,
                                noise_sigma_acc=0.5)
    jn = dict(noise_sigma_acc=jnp.float32(5.0), noise_seed=jnp.uint32(9),
              mac_chunks=2)
    tn = dict(noise_sigma_acc=torch.tensor(5.0),
              noise_seed=torch.tensor(9, dtype=torch.uint32), mac_chunks=2)
    want = np.asarray(jops.fq_conv1d_int(
        jnp.asarray(a.numpy()), jnp.asarray(w.numpy()), jnp.float32(0.1),
        ksize=3, impl="im2col", **jn))
    a2 = a.unsqueeze(2).repeat(1, 1, 2, 1)          # (2, 8, 2, 4)
    want_pool = np.asarray(jops.fq_conv2d_pool_int(
        jnp.asarray(a2.numpy()), jnp.asarray(w[:4].numpy()),
        jnp.float32(0.1), ksize=1, pool=2, impl="im2col", **jn))
    for impl in ("fused", "im2col"):
        np.testing.assert_array_equal(tops.fq_conv1d_int(
            a, w, s, ksize=3, impl=impl, **tn).numpy(), want)
        np.testing.assert_array_equal(tops.fq_conv2d_pool_int(
            a2, w[:4], s, ksize=1, pool=2, impl=impl, **tn).numpy(),
            want_pool)
    for fmt in ("ternary", "int4"):
        wp = tq.pack_im2col_codes(w, 3, fmt)
        for impl in ("fused", "im2col"):
            assert torch.equal(
                tops.fq_conv1d_int(a, wp, s, ksize=3, impl=impl,
                                   weight_format=fmt),
                tops.fq_conv1d_int(a, w, s, ksize=3, impl=impl))
        assert torch.equal(
            tops.int_matmul(a[0], tq.pack_codes(w[:4], fmt), s,
                            weight_format=fmt),
            tops.int_matmul(a[0], w[:4], s))
        with pytest.raises(ValueError):
            tops.fq_conv1d_int(a, w, s, ksize=3, impl="im2col",
                               weight_format=fmt)
        with pytest.raises(ValueError):
            tops.fq_conv1d_int(a, w, s, ksize=3, impl="fused",
                               weight_format=fmt)
    with pytest.raises(ValueError):
        tops.int_matmul(a[0], w[:4], s, weight_format="int2")
    with pytest.raises(ValueError):
        tops.fq_conv2d_pool_int(a.unsqueeze(2), w[:4], s, ksize=1,
                                weight_format="int2")


def test_cpu_path_launches_no_kernel():
    tkernels.reset_launch_counts()
    a = torch.zeros(1, 8, 4, dtype=torch.int8)
    tops.fq_conv1d_int(a, torch.zeros(12, 3, dtype=torch.int8),
                       torch.tensor(0.1), ksize=3, impl="fused")
    tops.fq_conv2d_pool_int(torch.zeros(1, 6, 6, 4, dtype=torch.int8),
                            torch.zeros(36, 3, dtype=torch.int8),
                            torch.tensor(0.1), ksize=3, padding=1,
                            impl="fused")
    quantize_codes(torch.zeros(4, 4), torch.tensor(1.0), n=7, b=0.0)
    assert tkernels.launch_counts() == {"quantize_codes": 0, "fq_matmul": 0,
                                        "fq_conv2d": 0, "fq_conv2d_pool": 0,
                                        "lm_island": 0}


def test_wrappers_refuse_other_devices():
    meta = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError):
        quantize_codes(meta, torch.tensor(1.0), n=7, b=0.0)
    with pytest.raises(ValueError):
        fq_matmul(meta.to(torch.int8), meta.to(torch.int8), torch.tensor(1.0))


# ---------------------------------------------------------------------------
# The tensor-core tile loop's A loader, picked on the host per launch
# ---------------------------------------------------------------------------


def _darknet_convs():
    """(cin, ksize) of DarkNet-19's integer convs at 224 x 224."""
    import chip_smoke
    from repro_torch.models.darknet import DarkNetConfig
    return [(cin, ks) for _, _, cin, _, ks, _ in
            chip_smoke.darknet_int_layers(DarkNetConfig(), 224)]


def test_loader_choice_darknet_shapes_take_vector():
    """Every DarkNet K3 (Cin 32 ... 1024) and im2col K2 (K = ks^2 Cin)
    launch takes the 16-byte vector loader at an aligned address."""
    from repro_torch.kernels.fq_conv import a_loader as conv_loader
    from repro_torch.kernels.fq_matmul import a_loader as matmul_loader
    convs = _darknet_convs()
    assert len(convs) == 17
    for cin, ks in convs:
        assert conv_loader(cin, 256) == "vector", cin
        assert matmul_loader(ks * ks * cin, 256) == "vector", (cin, ks)


@pytest.mark.parametrize("cin", [100, 45, 5, 70, 8, 24])
def test_loader_choice_kws_and_ragged_shapes_take_byte(cin):
    """KWS (cin 100 and 45, K = 3 cin = 300 and 135) and ragged shapes
    gather bytes; so do K2's ragged K (13, 257)."""
    from repro_torch.kernels.fq_conv import a_loader as conv_loader
    from repro_torch.kernels.fq_matmul import a_loader as matmul_loader
    assert conv_loader(cin, 256) == "byte"
    assert matmul_loader(3 * cin, 256) == "byte"
    for k in (13, 257, 135, 300):
        assert matmul_loader(k, 256) == "byte"


def test_loader_choice_misaligned_view_takes_byte():
    """A view at an odd byte offset takes the byte loader (the wrappers
    document it; nothing is refused for alignment), an aligned one the
    vector loader; B copies 16-byte chunks only for N % 16 == 0, aligned."""
    from repro_torch.kernels.fq_conv import a_loader as conv_loader
    from repro_torch.kernels.fq_matmul import a_loader as matmul_loader
    from repro_torch.kernels.fq_matmul import b_vector
    flat = torch.zeros(130 * 80 + 16, dtype=torch.int8)
    assert flat.data_ptr() % 16 == 0
    aligned, odd = flat[16:].view(130, 80), flat[1:1 + 130 * 80].view(130, 80)
    assert aligned.is_contiguous() and odd.is_contiguous()
    assert matmul_loader(80, aligned.data_ptr()) == "vector"
    assert matmul_loader(80, odd.data_ptr()) == "byte"
    assert conv_loader(16, odd.data_ptr()) == "byte"
    assert conv_loader(16, aligned.data_ptr()) == "vector"
    assert b_vector(48, flat.data_ptr()) and b_vector(1008, 32)
    assert not b_vector(45, flat.data_ptr()) and not b_vector(1000, 0)
    assert not b_vector(48, 8)


def test_cpu_path_uses_plain_versions_and_counts_no_vector_launch():
    """On the CPU, K2 and K3 at vector-loader shapes run the plain versions
    and count no launch of either loader."""
    tkernels.reset_launch_counts()
    rng = np.random.default_rng(16)
    a = _t(_codes(rng, (70, 80), -7, 7))
    b = _t(_codes(rng, (80, 48), -7, 7))
    s = torch.tensor(np.float32(0.01))
    assert torch.equal(fq_matmul(a, b, s, lo=-7),
                       tref.ref_fq_matmul(a, b, s, lo=-7))
    x = _t(_codes(rng, (2, 9, 7, 16), 0, 7))
    w = _t(_codes(rng, (9 * 16, 64), -1, 1))
    kw = dict(kh=3, kw=3, stride=(2, 2), padding=(1, 1), dilation=(2, 2))
    assert torch.equal(fq_conv2d(x, w, s, **kw),
                       tref.ref_fq_conv2d(x, w, s, **kw))
    assert tkernels.vector_launch_counts() == {"fq_matmul_vector": 0,
                                               "fq_conv2d_vector": 0,
                                               "fq_conv2d_pool_vector": 0}
    assert sum(tkernels.launch_counts().values()) == 0


def test_vector_kernels_include_k3b():
    """K3b runs on the tensor-core loop beside K2 and K3."""
    assert tkernels.VECTOR == ("fq_matmul", "fq_conv2d", "fq_conv2d_pool")


def test_reset_zeroes_k3b_vector_launches():
    from repro_torch.kernels.fq_conv import fq_conv2d_pool
    fq_conv2d_pool.vector_launches = 3
    tkernels.reset_launch_counts()
    assert fq_conv2d_pool.vector_launches == 0


def test_vector_launch_counts_read_k3b():
    from repro_torch.kernels.fq_conv import fq_conv2d_pool
    tkernels.reset_launch_counts()
    fq_conv2d_pool.vector_launches = 2
    try:
        assert tkernels.vector_launch_counts() == {
            "fq_matmul_vector": 0, "fq_conv2d_vector": 0,
            "fq_conv2d_pool_vector": 2}
    finally:
        tkernels.reset_launch_counts()


@pytest.mark.parametrize("pool", [(2, 2), (3, 3), (2, 3)])
@pytest.mark.parametrize("fmt", ["int8", "ternary"])
def test_cpu_pool_call_counts_no_launch(pool, fmt):
    """On the CPU, K3b at a vector-loader shape (Cin 32) runs the plain
    version and counts no launch of any kind: all, packed, noisy or
    vector."""
    from repro_torch.core.quant import format_range, pack_im2col_codes
    tkernels.reset_launch_counts()
    rng = np.random.default_rng(32 + pool[1])
    x = _t(_codes(rng, (2, 13, 15, 32), 0, 7))
    r = format_range(fmt)
    w = _t(_codes(rng, (9 * 32, 64), -r, r))
    wp = w if fmt == "int8" else pack_im2col_codes(w, 9, fmt)
    s = torch.tensor(np.float32(0.0131))
    kw = dict(kh=3, kw=3, padding=(1, 1), pool=pool, n_out=7, lo=-7,
              weight_format=fmt)
    assert torch.equal(fq_conv2d(x, wp, s, **kw),
                       tref.ref_fq_conv2d(x, wp, s, **kw))
    counts = (tkernels.launch_counts(), tkernels.packed_launch_counts(),
              tkernels.noisy_launch_counts(), tkernels.vector_launch_counts())
    assert all(v == 0 for c in counts for v in c.values()), counts
    assert "fq_conv2d_pool_vector" in counts[3]
