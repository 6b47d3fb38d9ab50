"""The CUDA kernels of repro_torch against their plain versions, on the card.

Every test here is marked ``cuda`` and skips on a machine without a CUDA
device. This file imports only torch, numpy and the port, so it also runs
where JAX is not installed; there, skip the repo's conftest (which imports
JAX) and run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The plain versions themselves are held against the JAX reference on the CPU
in ``test_torch_kernels.py`` and ``test_torch_kws.py``; here each kernel
must match its plain version bit for bit on the same CUDA inputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import integer_inference as tii
from repro_torch.core import quant as tq
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fq_conv import a_loader as conv_a_loader
from repro_torch.kernels.fq_conv import (fq_conv2d, fq_conv2d_pool,
                                        splitk_epilogue)
from repro_torch.kernels.fq_matmul import a_loader as matmul_a_loader
from repro_torch.kernels.fq_matmul import fq_matmul
from repro_torch.kernels.quantize import quantize_codes
from repro_torch.models import darknet as tdn
from repro_torch.models import kws as tkws

pytestmark = pytest.mark.cuda

# K % 16 == 0 takes the tensor-core loop's vector A loader, any other K the
# byte one; M past a 64-row tile, K past a 64-code stage (80), N of 16, 48
# and 1000 cross both B loaders (16-byte cp.async needs N % 16 == 0)
MATMUL_SHAPES = [(37, 13, 5), (130, 257, 129), (1, 64, 64), (64, 64, 64),
                 (4 * 138, 300, 45), (4 * 12, 135, 45), (100, 80, 16),
                 (130, 80, 48), (200, 128, 1000), (3 * 64 + 5, 4608, 64)]
KWS_LAYERS = [(140, 100, 1), (138, 45, 1), (136, 45, 2), (132, 45, 4),
              (124, 45, 8), (108, 45, 16), (76, 45, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _codes(rng, shape, lo, hi, dev):
    return torch.from_numpy(rng.integers(lo, hi + 1, size=shape).astype(
        np.int8)).to(dev)


@pytest.mark.parametrize("rows,cols", [(140, 100), (64 * 140, 100), (7, 3)])
def test_quantize_codes_matches_plain(cuda, rows, cols):
    rng = np.random.default_rng(rows)
    x = torch.from_numpy((rng.standard_normal((rows, cols)) * 2).astype(
        np.float32)).to(cuda)
    inv = torch.tensor(np.float32(0.7), device=cuda)
    before = quantize_codes.launches
    got = quantize_codes(x, inv, n=7, b=0.0)
    torch.cuda.synchronize()
    assert quantize_codes.launches == before + 1
    assert torch.equal(got, tref.ref_quantize_codes(x, inv, n=7, b=0.0))


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


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_codes_half_lsb_ties(cuda, bits):
    """rint, not roundf: a code exactly on k + 0.5 goes to the even one."""
    n = 2 ** (bits - 1) - 1
    u = _half_lsb_ties(n)
    assert len(u) == 2 * n
    x = torch.from_numpy(u).reshape(1, -1).to(cuda)
    inv = torch.tensor(1.0, device=cuda)
    got = quantize_codes(x, inv, n=n, b=-1.0)
    assert torch.equal(got, tref.ref_quantize_codes(x, inv, n=n, b=-1.0))
    assert (got.cpu().to(torch.int32) % 2 == 0).all()


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("epilogue,lo", [("requant", 0), ("requant", -7),
                                         ("dequant", 0)])
def test_fq_matmul_matches_plain(cuda, m, k, n, epilogue, lo):
    rng = np.random.default_rng(m + k + n)
    a = _codes(rng, (m, k), -127, 127, cuda)
    b = _codes(rng, (k, n), -127, 127, cuda)
    s = torch.tensor(np.float32(1e-3), device=cuda)
    kw = dict(epilogue=epilogue, n_out=7, lo=lo)
    before = fq_matmul.vector_launches
    got = fq_matmul(a, b, s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.ref_fq_matmul(a, b, s, **kw))
    assert fq_matmul.vector_launches - before == (k % 16 == 0)


@pytest.mark.parametrize("k", [80, 4608])
def test_fq_matmul_misaligned_a_takes_byte_loader(cuda, k):
    """A view at a 1-byte offset: the byte loader, the same codes."""
    rng = np.random.default_rng(k)
    flat = _codes(rng, (130 * k + 1,), -127, 127, cuda)
    a = flat[1:].view(130, k)
    assert matmul_a_loader(k, a.data_ptr()) == "byte"
    b = _codes(rng, (k, 48), -127, 127, cuda)
    s = torch.tensor(np.float32(1e-3), device=cuda)
    before = fq_matmul.vector_launches
    got = fq_matmul(a, b, s, n_out=7, lo=-7)
    torch.cuda.synchronize()
    assert fq_matmul.vector_launches == before
    assert torch.equal(got, tref.ref_fq_matmul(a, b, s, n_out=7, lo=-7))
    assert torch.equal(got, fq_matmul(a.contiguous().clone(), b, s,
                                      n_out=7, lo=-7))


def test_int_accumulate_exact_on_the_card(cuda):
    rng = np.random.default_rng(3)
    a = _codes(rng, (64, 2048), -127, 127, cuda)
    b = _codes(rng, (2048, 32), -127, 127, cuda)
    want = a.cpu().to(torch.int32) @ b.cpu().to(torch.int32)
    assert torch.equal(tref.int_accumulate(a, b).cpu(), want)


@pytest.mark.parametrize("ksize,stride,padding,dilation", [
    (3, 2, 1, 1), (3, 1, 1, 2), (3, 2, 1, 2), (1, 1, 0, 1)])
@pytest.mark.parametrize("epilogue", ["requant", "dequant"])
@pytest.mark.parametrize("cin,cout", [(70, 67), (16, 64), (48, 1000)])
def test_fq_conv2d_matches_plain(cuda, ksize, stride, padding, dilation,
                                 epilogue, cin, cout):
    """cin 70 takes the byte A loader, 16 and 48 the vector one."""
    rng = np.random.default_rng(ksize + stride + dilation + cin)
    a = _codes(rng, (3, 17, 13, cin), 0, 15, cuda)
    w = _codes(rng, (ksize * ksize * cin, cout), -7, 7, cuda)
    s = torch.tensor(np.float32(0.011), device=cuda)
    kw = dict(kh=ksize, kw=ksize, stride=(stride, stride),
              padding=(padding, padding), dilation=(dilation, dilation),
              epilogue=epilogue, n_out=15, lo=0)
    before = fq_conv2d.vector_launches
    got = fq_conv2d(a, w, s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.ref_fq_conv2d(a, w, s, **kw))
    assert fq_conv2d.vector_launches - before == (cin % 16 == 0)


@pytest.mark.parametrize("t,cin,dil", KWS_LAYERS)
def test_kws_conv_fused_equals_im2col(cuda, t, cin, dil):
    rng = np.random.default_rng(t + dil)
    a = _codes(rng, (8, t, cin), 0, 7, cuda)
    w = _codes(rng, (3 * cin, 45), -1, 1, cuda)
    s = torch.tensor(np.float32(0.0213), device=cuda)
    kw = dict(ksize=3, dilation=dil, n_out=7, lo=0)
    fused = tops.fq_conv1d_int(a, w, s, impl="fused", **kw)
    im2col = tops.fq_conv1d_int(a, w, s, impl="im2col", **kw)
    torch.cuda.synchronize()
    assert torch.equal(fused, im2col)
    assert torch.equal(fused.cpu(), tops.fq_conv1d_int(
        a.cpu(), w.cpu(), s.cpu(), impl="fused", **kw))


def test_kws_serving_on_the_card(cuda):
    """The port's own full-width stack: GPU int_core == CPU int_core given
    the same entry codes; fused and im2col logits identical."""
    cfg, qcfg = tkws.KWSConfig(), QuantConfig(2, 4, 4, fq=True)
    params, state = tkws.init(torch.Generator().manual_seed(0), cfg)
    params = tkws.to_fq(params, state, cfg)
    names = tkws.conv_names(cfg)
    for n in names:
        params[n] = {**params[n], "s_out": torch.tensor(0.1, device=cuda)}
    stack = tkws.convert_int(tii.sync_handoff(params, names), state, qcfg,
                             cfg)
    assert stack.device.type == "cuda"
    x = np.random.default_rng(1).standard_normal(
        (4, cfg.seq_len, cfg.n_mfcc)).astype(np.float32)
    fused = tkws.int_serve_fn(stack, qcfg, cfg, impl="fused")(x)
    im2col = tkws.int_serve_fn(stack, qcfg, cfg, impl="im2col")(x)
    assert torch.equal(fused, im2col) and torch.isfinite(fused).all()
    codes = torch.randint(0, 8, (4, cfg.seq_len, cfg.embed), dtype=torch.int8,
                          generator=torch.Generator().manual_seed(2))
    gpu = tkws.int_core(stack, codes.to(cuda), qcfg, cfg)
    cpu = tkws.int_core(stack.to("cpu"), codes, qcfg, cfg)
    assert torch.equal(gpu.cpu(), cpu)


# (B, H, W, Cin, Cout) of DarkNet-19's four pooled convs at 224 x 224, B=1
DARKNET_POOLED = [(1, 112, 112, 32, 64), (1, 56, 56, 64, 128),
                  (1, 28, 28, 128, 256), (1, 14, 14, 256, 512)]


# Cin 16 and 48 take the vector A loader on windows that end past a 16- and
# a 64-row tile (Mp 84 and 42 at pool 2) and Cout past a 64-column tile
POOL_EDGES = [(2, 13, 15, 16, 64), (2, 13, 15, 48, 1000),
              (1, 13, 15, 48, 48)]


@pytest.mark.parametrize("shape", DARKNET_POOLED + [(2, 13, 15, 40, 70)]
                         + POOL_EDGES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("pool", [2, 3])
@pytest.mark.parametrize("epilogue,lo", [("requant", 0), ("requant", -7),
                                         ("dequant", 0)])
def test_fq_conv2d_pool_matches_plain(cuda, shape, pool, epilogue, lo):
    """K3b on the tensor-core loop: DarkNet's pooled convs and Cin 16 / 48
    take the vector A loader, Cin 40 the byte one."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(h + cin + pool)
    a = _codes(rng, (b, h, w, cin), 0, 7, cuda)
    wc = _codes(rng, (9 * cin, cout), -1, 1, cuda)
    s = torch.tensor(np.float32(0.0131), device=cuda)
    kw = dict(kh=3, kw=3, padding=(1, 1), pool=(pool, pool),
              epilogue=epilogue, n_out=7, lo=lo)
    before = fq_conv2d.launches, fq_conv2d_pool.launches
    vec = fq_conv2d_pool.vector_launches
    got = fq_conv2d(a, wc, s, **kw)
    torch.cuda.synchronize()
    assert (fq_conv2d.launches, fq_conv2d_pool.launches) == \
        (before[0], before[1] + 1)
    assert fq_conv2d_pool.vector_launches - vec == (cin % 16 == 0)
    assert got.shape == (b, h // pool, w // pool, cout)
    assert torch.equal(got, tref.ref_fq_conv2d(a, wc, s, **kw))
    im2col = tops.fq_conv2d_pool_int(a, wc, s, ksize=3, padding=1, pool=pool,
                                     epilogue=epilogue, n_out=7, lo=lo,
                                     impl="im2col")
    assert torch.equal(got, im2col)


@pytest.mark.parametrize("pool", [2, 3])
def test_fq_conv2d_pool_misaligned_a_takes_byte_loader(cuda, pool):
    """An activation view at a 1-byte offset: K3b's byte loader, the same
    codes as the aligned copy on the vector loader."""
    rng = np.random.default_rng(40 + pool)
    shape = (2, 13, 15, 32)
    flat = _codes(rng, (int(np.prod(shape)) + 1,), 0, 7, cuda)
    a = flat[1:].view(shape)
    assert conv_a_loader(32, a.data_ptr()) == "byte"
    wc = _codes(rng, (9 * 32, 64), -1, 1, cuda)
    s = torch.tensor(np.float32(0.0131), device=cuda)
    kw = dict(kh=3, kw=3, padding=(1, 1), pool=(pool, pool), n_out=7, lo=-7)
    before = fq_conv2d_pool.vector_launches
    got = fq_conv2d(a, wc, s, **kw)
    torch.cuda.synchronize()
    assert fq_conv2d_pool.vector_launches == before
    assert torch.equal(got, tref.ref_fq_conv2d(a, wc, s, **kw))
    assert torch.equal(got, fq_conv2d(a.contiguous().clone(), wc, s, **kw))
    assert fq_conv2d_pool.vector_launches == before + 1


def _darknet_reduced_stack(dev, weight_format=None):
    """The port's reduced DarkNet stack, s_out set per layer so codes stay
    live, with the hand-off contract enforced."""
    cfg, qcfg = tdn.DarkNetConfig.reduced(), QuantConfig(2, 4, 4, fq=True)
    params, state = tdn.init(torch.Generator().manual_seed(0), cfg,
                             device=dev)
    params = tdn.to_fq(params, state, cfg)
    names = tdn.int_conv_names(cfg)
    params[names[0]] = {**params[names[0]],
                        "s_in": torch.tensor(0.5, device=dev)}
    for i, n in enumerate(names):
        params[n] = {**params[n], "s_out": torch.tensor(0.5 + 0.3 * i,
                                                        device=dev)}
    stack = tdn.convert_int(tii.sync_handoff(params, names), state, qcfg,
                            cfg, weight_format=weight_format)
    return cfg, qcfg, stack


def test_darknet_reduced_serving_on_the_card(cuda):
    """fused, fused without pool fusion and im2col give identical logits and
    codes; the GPU int_core equals the CPU one given the same entry codes."""
    cfg, qcfg, stack = _darknet_reduced_stack(cuda)
    assert stack.device.type == "cuda"
    x = np.random.default_rng(1).standard_normal((4, 16, 16, 3)).astype(
        np.float32)
    ways = [dict(impl="fused"), dict(impl="fused", fuse_pool=False),
            dict(impl="im2col")]
    before = fq_conv2d_pool.launches
    logits = [tdn.int_serve_fn(stack, qcfg, cfg, **kw)(x) for kw in ways]
    assert fq_conv2d_pool.launches == before + 1
    for other in logits[1:]:
        assert torch.equal(logits[0], other)
    assert torch.isfinite(logits[0]).all()
    codes = torch.randint(0, 8, (4, 8, 8, 8), dtype=torch.int8,
                          generator=torch.Generator().manual_seed(2))
    gpu = [tdn.int_core(stack, codes.to(cuda), qcfg, cfg, **kw)
           for kw in ways]
    cpu = tdn.int_core(stack.to("cpu"), codes, qcfg, cfg)
    for g in gpu:
        assert torch.equal(g.cpu(), cpu)
    assert (cpu != 0).any()


# ---------------------------------------------------------------------------
# K5: packed weights (int4, ternary) in K2, K3 and K3b
# ---------------------------------------------------------------------------

PACKED = ("int4", "ternary")


@pytest.mark.parametrize("fmt", PACKED)
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES + [(8 * 138, 300, 45)])
@pytest.mark.parametrize("epilogue,lo", [("requant", 0), ("requant", -7),
                                         ("dequant", 0)])
def test_fq_matmul_packed_matches_plain(cuda, fmt, m, k, n, epilogue, lo):
    """K not a multiple of the factor (13, 257, 135 ...) included."""
    rng = np.random.default_rng(m + k + n + len(fmt))
    r = tq.format_range(fmt)
    a = _codes(rng, (m, k), -127, 127, cuda)
    w = _codes(rng, (k, n), -r, r, cuda)
    b = tq.pack_codes(w, fmt)
    s = torch.tensor(np.float32(1e-3), device=cuda)
    kw = dict(epilogue=epilogue, n_out=7, lo=lo)
    before = fq_matmul.packed_launches[fmt]
    got = fq_matmul(a, b, s, weight_format=fmt, **kw)
    torch.cuda.synchronize()
    assert fq_matmul.packed_launches[fmt] == before + 1
    assert torch.equal(got, tref.ref_fq_matmul(a, b, s, weight_format=fmt,
                                               **kw))
    assert torch.equal(got, fq_matmul(a, w, s, **kw))


@pytest.mark.parametrize("fmt", PACKED)
@pytest.mark.parametrize("cin", [5, 45, 64, 16])
@pytest.mark.parametrize("pool", [None, 2, 3])
@pytest.mark.parametrize("epilogue,lo", [("requant", 0), ("requant", -7),
                                         ("dequant", 0)])
def test_fq_conv2d_packed_matches_plain(cuda, fmt, cin, pool, epilogue, lo):
    """Ragged cin: the kernel reduces over taps x cin_p and loads 0 for the
    pad channels, on a strided, padded, dilated conv and with K3b."""
    rng = np.random.default_rng(cin + (pool or 0))
    r = tq.format_range(fmt)
    a = _codes(rng, (2, 17, 13, cin), 0, 15, cuda)
    w = _codes(rng, (9 * cin, 67), -r, r, cuda)
    wp = tq.pack_im2col_codes(w, 9, fmt)
    s = torch.tensor(np.float32(0.011), device=cuda)
    kw = dict(kh=3, kw=3, stride=(1, 2), padding=(1, 1), dilation=(2, 1),
              pool=None if pool is None else (pool, pool),
              epilogue=epilogue, n_out=15, lo=lo)
    counted = fq_conv2d if pool is None else fq_conv2d_pool
    before = counted.packed_launches[fmt]
    vec = counted.vector_launches
    got = fq_conv2d(a, wp, s, weight_format=fmt, **kw)
    torch.cuda.synchronize()
    assert counted.packed_launches[fmt] == before + 1
    assert counted.vector_launches - vec == (cin % 16 == 0)
    assert torch.equal(got, tref.ref_fq_conv2d(a, wp, s, weight_format=fmt,
                                               **kw))
    assert torch.equal(got, fq_conv2d(a, w, s, **kw))


@pytest.mark.parametrize("fmt", PACKED)
@pytest.mark.parametrize("t,cin,dil", KWS_LAYERS)
def test_kws_conv_packed_fused_equals_im2col(cuda, fmt, t, cin, dil):
    rng = np.random.default_rng(t + dil + len(fmt))
    a = _codes(rng, (8, t, cin), 0, 7, cuda)
    w = tq.pack_im2col_codes(_codes(rng, (3 * cin, 45), -1, 1, cuda), 3, fmt)
    s = torch.tensor(np.float32(0.0213), device=cuda)
    kw = dict(ksize=3, dilation=dil, n_out=7, lo=0, weight_format=fmt)
    fused = tops.fq_conv1d_int(a, w, s, impl="fused", **kw)
    im2col = tops.fq_conv1d_int(a, w, s, impl="im2col", **kw)
    torch.cuda.synchronize()
    assert torch.equal(fused, im2col)


def test_packed_stacks_serve_like_int8_on_the_card(cuda):
    """KWS full width and reduced DarkNet: ternary and int4 stacks give the
    int8 stack's logits under every impl, through the packed kernels."""
    from repro_torch import kernels
    cfg, qcfg = tkws.KWSConfig(), QuantConfig(2, 4, 4, fq=True)
    params, state = tkws.init(torch.Generator().manual_seed(0), cfg)
    params = tkws.to_fq(params, state, cfg)
    names = tkws.conv_names(cfg)
    for n in names:
        params[n] = {**params[n], "s_out": torch.tensor(0.1, device=cuda)}
    params = tii.sync_handoff(params, names)
    x = np.random.default_rng(1).standard_normal(
        (4, cfg.seq_len, cfg.n_mfcc)).astype(np.float32)
    want = tkws.int_serve_fn(tkws.convert_int(params, state, qcfg, cfg),
                             qcfg, cfg, impl="fused")(x)
    for fmt in ("auto", "int4"):
        stack = tkws.convert_int(params, state, qcfg, cfg, weight_format=fmt)
        kernels.reset_launch_counts()
        fused = tkws.int_serve_fn(stack, qcfg, cfg, impl="fused")(x)
        torch.cuda.synchronize()
        packed = kernels.packed_launch_counts()
        f = "ternary" if fmt == "auto" else fmt
        assert packed[f"fq_conv2d_{f}"] == len(names)
        assert torch.equal(fused, want)
        assert torch.equal(tkws.int_serve_fn(stack, qcfg, cfg,
                                             impl="im2col")(x), want)
    dcfg, dq, d8 = _darknet_reduced_stack(cuda)
    xd = np.random.default_rng(1).standard_normal((4, 16, 16, 3)).astype(
        np.float32)
    want = tdn.int_serve_fn(d8, dq, dcfg, impl="fused")(xd)
    for fmt in PACKED:
        _, _, stack = _darknet_reduced_stack(cuda, weight_format=fmt)
        for kw in (dict(impl="fused"), dict(impl="fused", fuse_pool=False),
                   dict(impl="im2col")):
            assert torch.equal(tdn.int_serve_fn(stack, dq, dcfg, **kw)(xd),
                               want)


# ---------------------------------------------------------------------------
# K4: the ADC-noise epilogue in K2, K3 and K3b
# ---------------------------------------------------------------------------

FORMATS = ("int8",) + PACKED


def _noise(cuda, scale, chunks, seed=4107458132):
    """sigma ~ 1.5 output LSB in accumulator units, a uint32 seed."""
    return dict(noise_sigma_acc=torch.tensor(np.float32(1.5 / scale),
                                             device=cuda),
                noise_seed=torch.tensor(seed, dtype=torch.uint32,
                                        device=cuda),
                mac_chunks=chunks)


def test_threefry_on_the_card(cuda):
    """The reference values chip_smoke.py checks (jax 0.9)."""
    from repro_torch.core import prng
    from repro_torch.core.noise import derive_seed
    keys = prng.split(prng.PRNGKey(5, device=cuda), 3)
    assert keys[0].tolist() == [2724472204, 3573582090]
    seed = derive_seed(keys[2])
    assert seed.dtype == torch.uint32 and int(seed) == 4107458132
    u = prng.uniform(keys[1], 4096)
    assert torch.equal(u.cpu(), prng.uniform(keys[1].cpu(), 4096))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("m,k,n", [(37, 13, 5), (130, 257, 129),
                                   (4 * 138, 300, 45), (130, 80, 48),
                                   (200, 128, 1000)])
@pytest.mark.parametrize("epilogue,lo", [("requant", -7), ("dequant", 0)])
def test_fq_matmul_noisy_matches_plain(cuda, fmt, chunks, m, k, n, epilogue,
                                       lo):
    rng = np.random.default_rng(m + k + chunks)
    r = tq.format_range(fmt)
    a = _codes(rng, (m, k), -127, 127, cuda)
    w = _codes(rng, (k, n), -r, r, cuda)
    b = w if fmt == "int8" else tq.pack_codes(w, fmt)
    s = torch.tensor(np.float32(1e-3), device=cuda)
    kw = dict(epilogue=epilogue, n_out=7, lo=lo, weight_format=fmt,
              **_noise(cuda, 1e-3, chunks))
    before = fq_matmul.noisy_launches
    got = fq_matmul(a, b, s, **kw)
    torch.cuda.synchronize()
    assert fq_matmul.noisy_launches == before + 1
    assert torch.equal(got, tref.ref_fq_matmul(a, b, s, **kw))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("cin", [5, 64, 48])
@pytest.mark.parametrize("pool", [None, 2, 3])
def test_fq_conv2d_noisy_matches_plain(cuda, fmt, chunks, cin, pool):
    """K3 and K3b (2 x 2 and the generic pool) with the noise at each
    window position's unpooled index, ragged cin, lo < 0."""
    rng = np.random.default_rng(cin + (pool or 0) + chunks)
    r = tq.format_range(fmt)
    a = _codes(rng, (2, 17, 13, cin), 0, 15, cuda)
    w = _codes(rng, (9 * cin, 67), -r, r, cuda)
    wp = w if fmt == "int8" else tq.pack_im2col_codes(w, 9, fmt)
    s = torch.tensor(np.float32(0.011), device=cuda)
    kw = dict(kh=3, kw=3, stride=(1, 2), padding=(1, 1), dilation=(2, 1),
              pool=None if pool is None else (pool, pool), n_out=15, lo=-15,
              weight_format=fmt, **_noise(cuda, 0.011, chunks))
    counted = fq_conv2d if pool is None else fq_conv2d_pool
    before = counted.noisy_launches
    vec = counted.vector_launches
    got = fq_conv2d(a, wp, s, **kw)
    torch.cuda.synchronize()
    assert counted.noisy_launches == before + 1
    assert counted.vector_launches - vec == (cin % 16 == 0)
    assert torch.equal(got, tref.ref_fq_conv2d(a, wp, s, **kw))


@pytest.mark.parametrize("chunks", [1, 4])
def test_noisy_stacks_serve_on_the_card(cuda, chunks):
    """Reduced KWS and DarkNet, int8 and ternary: under noise every impl
    gives the same logits, the fused path launches only noisy K3 / K3b, and
    the noise moves the logits."""
    from repro_torch import kernels
    from repro_torch.core import prng
    from repro_torch.core.noise import TABLE7_CONDITIONS
    cond, key = TABLE7_CONDITIONS[-1], prng.PRNGKey(5)
    dcfg, dq, _ = _darknet_reduced_stack(cuda)
    xd = np.random.default_rng(1).standard_normal((4, 16, 16, 3)).astype(
        np.float32)
    for fmt in ("int8", "ternary"):
        _, _, stack = _darknet_reduced_stack(cuda, weight_format=fmt)
        clean = tdn.int_serve_fn(stack, dq, dcfg, impl="fused")(xd)
        kernels.reset_launch_counts()
        want = tdn.int_serve_fn(stack, dq, dcfg, impl="fused",
                                mac_chunks=chunks)(xd, noise=cond, rng=key)
        torch.cuda.synchronize()
        counts, noisy = kernels.launch_counts(), kernels.noisy_launch_counts()
        assert counts["fq_matmul"] == 0
        assert noisy["fq_conv2d_noisy"] == counts["fq_conv2d"] > 0
        assert noisy["fq_conv2d_pool_noisy"] == counts["fq_conv2d_pool"] > 0
        assert not torch.equal(want, clean)
        for kw in (dict(impl="fused", fuse_pool=False), dict(impl="im2col")):
            assert torch.equal(tdn.int_serve_fn(
                stack, dq, dcfg, mac_chunks=chunks, **kw)(
                    xd, noise=cond, rng=key), want)


# ---------------------------------------------------------------------------
# CNN serving: clean flushes replayed as CUDA graphs from pinned staging
# ---------------------------------------------------------------------------


def _kws_reduced_stack(dev, weight_format=None):
    """The port's reduced KWS stack, s_out 0.1 per layer, handed off."""
    cfg, qcfg = tkws.KWSConfig.reduced(), QuantConfig(2, 4, 4, fq=True)
    params, state = tkws.init(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    params = tkws.to_fq(params, state, cfg)
    names = tkws.conv_names(cfg)
    for n in names:
        params[n] = {**params[n], "s_out": torch.tensor(0.1, device=dev)}
    stack = tkws.convert_int(tii.sync_handoff(params, names), state, qcfg,
                             cfg, weight_format=weight_format)
    return cfg, qcfg, stack


def _served(model, dev, weight_format=None):
    """(int_serve_fn, ladder, request sampler) of a reduced model."""
    from repro_torch.models import frontends
    if model == "kws":
        cfg, qcfg, stack = _kws_reduced_stack(dev, weight_format)
        return (tkws.int_serve_fn(stack, qcfg, cfg),
                frontends.kws_serving_ladder(cfg, (16, 24)),
                lambda rng: rng.standard_normal(
                    (int(rng.integers(10, 30)), cfg.n_mfcc)))
    cfg, qcfg, stack = _darknet_reduced_stack(dev, weight_format)
    return (tdn.int_serve_fn(stack, qcfg, cfg),
            frontends.darknet_serving_ladder(cfg, (12, 16)),
            lambda rng: rng.standard_normal(
                tuple(int(v) for v in rng.integers(8, 20, size=2)) + (3,)))


def _serve_trace(fn, ladder, sample, seed=0, ticks=8, **kw):
    """A seeded bursty trace through a batcher, tick by tick; returns
    (batcher, requests, [requests of each resolved flush])."""
    from repro_torch.serve import cnn_batching as tcb
    flushes = []
    b = tcb.CNNBatcher(fn, ladder=ladder, on_event=lambda e, f: (
        flushes.append(f["reqs"]) if e == "resolve" else None), **kw)
    rng, reqs = np.random.default_rng(seed), []
    for _ in range(ticks):
        new = [tcb.CNNRequest(rid=len(reqs) + i,
                              x=sample(rng).astype(np.float32))
               for i in range(int(rng.integers(0, 6)))]
        b.submit(new)
        reqs.extend(new)
        b.tick()
    while b.outstanding():
        b.tick()
    assert all(r.done and r.error is None for r in reqs)
    return b, reqs, flushes


def _eager_rows(fn, reqs, max_batch, **kw):
    """The flush's padded batch through the eager step."""
    from repro_torch.serve.cnn_batching import batch_bucket
    x = np.zeros((batch_bucket(len(reqs), max_batch),)
                 + reqs[0].x_served.shape, np.float32)
    for i, r in enumerate(reqs):
        x[i] = r.x_served
    return fn(x, **kw).cpu().numpy()[:len(reqs)]


@pytest.mark.parametrize("model", ["kws", "darknet"])
@pytest.mark.parametrize("dispatch_ahead", [False, True])
def test_graph_served_equals_eager(cuda, model, dispatch_ahead):
    """Every clean flush replays a graph, at most one per signature, and
    gives the eager step's bytes on the same padded batch; K1, K3 and K3b
    were captured (counted at capture, never at replay)."""
    from repro_torch import kernels
    fn, ladder, sample = _served(model, cuda)
    kernels.reset_launch_counts()
    b, reqs, flushes = _serve_trace(fn, ladder, sample, max_batch=4,
                                    dispatch_ahead=dispatch_ahead,
                                    max_inflight=3)
    counts = kernels.launch_counts()
    st = b.step_stats
    assert st["graph_flushes"] == b.stats["flushes"] == len(flushes) > 0
    assert st["eager_flushes"] == 0
    assert 0 < b.n_graphs == st["captures"] <= b.n_signatures
    for batch in flushes:
        want = _eager_rows(fn, batch, 4)
        for r, row in zip(batch, want):
            assert r.out.dtype == row.dtype and np.array_equal(r.out, row)
    assert counts["quantize_codes"] > 0 and counts["fq_conv2d"] > 0
    assert (counts["fq_conv2d_pool"] > 0) == (model == "darknet")


def test_pinned_staging_reuse_under_full_window(cuda):
    """A slow step (a device sleep) keeps both window slots busy while the
    host packs ahead: each staging buffer is refilled only after its copy
    completed, so every output is of its own batch."""
    from repro_torch.serve import cnn_batching as tcb

    def slow(x):
        torch.cuda._sleep(2_000_000)
        return x.sum(dim=(1, 2)) * 3.0 + x.amax(dim=(1, 2))
    slow.device = cuda
    b = tcb.CNNBatcher(slow, max_batch=2, max_wait_ticks=50,
                       dispatch_ahead=True, max_inflight=2)
    rng = np.random.default_rng(3)
    reqs = [tcb.CNNRequest(rid=i, x=rng.standard_normal((5, 3)).astype(
        np.float32)) for i in range(12)]
    b.submit(reqs)
    assert b.drain() == 12
    assert b.stats["inflight_peak"] == 2 and b.n_graphs == 1
    assert sum(buf is not None for buf in b._lanes[0].staging._bufs) == 2
    for r in reqs:
        x = torch.from_numpy(r.x)[None].to(cuda)
        assert np.array_equal(r.out, (x.sum(dim=(1, 2)) * 3.0 + x.amax(
            dim=(1, 2))).cpu().numpy()[0])


def test_lane_count_invariance(cuda):
    """One, two and three lanes (streams) serve the same trace to the same
    bytes; each lane captures its own graphs."""
    fn, ladder, sample = _served("kws", cuda, weight_format="auto")
    outs = {}
    for n in (1, 2, 3):
        b, reqs, _ = _serve_trace(fn, ladder, sample, seed=4, max_batch=4,
                                  dispatch_ahead=True, max_inflight=2,
                                  n_replicas=n)
        assert b.step_stats["graph_flushes"] == b.stats["flushes"]
        assert b.n_graphs <= n * b.n_signatures
        assert sum(l["flushes"] > 0 for l in b.stats["replicas"]) > n // 2
        outs[n] = [r.out for r in reqs]
    for n in (2, 3):
        assert all(np.array_equal(a, c) for a, c in zip(outs[1], outs[n]))


def test_swap_releases_graphs_after_inflight_resolve(cuda):
    """The old generation's graphs live while its flushes are in flight
    and are released when they resolve; each output is its generation's."""
    from repro_torch.serve import cnn_batching as tcb

    def gen(g):
        def fn(x):
            return x.sum(dim=1) * (3 + g) - g
        fn.device = cuda
        return fn
    b = tcb.CNNBatcher(gen(0), max_batch=2, max_wait_ticks=0,
                       dispatch_ahead=True, max_inflight=4)
    first = [tcb.CNNRequest(rid=i, x=np.full(4, i, np.float32))
             for i in range(4)]
    b.submit(first)
    b.tick()                              # two flushes in flight, gen 0
    assert b.in_flight == 4 and b.n_graphs == 1
    b.swap_apply_fn(gen(1))
    assert b.n_graphs == 1                # held by the in-flight flushes
    b.tick()                              # they resolve: released
    assert all(r.done for r in first) and b.n_graphs == 0
    second = [tcb.CNNRequest(rid=10 + i, x=np.full(4, i, np.float32))
              for i in range(2)]
    b.submit(second)
    b.drain()
    assert b.n_graphs == 1 and b.step_stats["captures"] == 2
    for r, g in [(r, 0) for r in first] + [(r, 1) for r in second]:
        assert r.generation == g
        assert r.out == np.float32(r.x.sum() * (3 + g) - g)


def test_noise_canary_runs_eagerly_on_the_card(cuda):
    """Noisy flushes run the eager step on the lane's stream with the
    flush's fold_in key, and equal the eager noisy step on that batch."""
    from repro_torch.core import prng
    from repro_torch.core.noise import TABLE7_CONDITIONS
    fn, ladder, sample = _served("kws", cuda)
    cond = TABLE7_CONDITIONS[-1]
    b, _, flushes = _serve_trace(fn, ladder, sample, ticks=3, max_batch=2,
                                 noise_config=cond, noise_seed=5)
    assert b.step_stats["eager_flushes"] == b.stats["flushes"] \
        == b.stats["noise_trials"] == len(flushes) > 0
    assert b.step_stats["graph_flushes"] == b.n_graphs == 0
    for trial, batch in enumerate(flushes):
        key = prng.fold_in(prng.PRNGKey(5), trial).to(cuda)
        want = _eager_rows(fn, batch, 2, noise=cond, rng=key)
        for r, row in zip(batch, want):
            assert np.array_equal(r.out, row)


# ---------------------------------------------------------------------------
# K1's vector kernel at its edges, and K3's split-K (the tile policy's bc)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 15, 16, 17, 4095, 4097, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4, 7])
def test_quantize_codes_odd_n_and_unaligned_views(cuda, n, offset):
    """Any length and any float offset (x[offset:], 4 bytes a step): the
    scalar head, the vector body with 16- or 1-byte stores, the tail."""
    rng = np.random.default_rng(n + offset)
    flat = torch.from_numpy((rng.standard_normal(n + offset) * 2).astype(
        np.float32)).to(cuda)
    x = flat[offset:]
    inv = torch.tensor(np.float32(0.9), device=cuda)
    for b, bits in ((0.0, 4), (-1.0, 8)):
        nl = 2 ** (bits - 1) - 1
        got = quantize_codes(x, inv, n=nl, b=b)
        torch.cuda.synchronize()
        assert torch.equal(got, tref.ref_quantize_codes(x, inv, n=nl, b=b))


@pytest.mark.parametrize("shape", [(64 * 140, 100), (8 * 112 * 112, 32)])
def test_quantize_codes_model_shapes_and_row_views(cuda, shape):
    """KWS B=64's and DarkNet B=8's entry shapes, and a view one row in."""
    rng = np.random.default_rng(shape[1])
    x = torch.from_numpy((rng.standard_normal(shape) * 1.5).astype(
        np.float32)).to(cuda)
    inv = torch.tensor(np.float32(0.8), device=cuda)
    for v in (x, x[1:], x[:-1]):
        assert torch.equal(quantize_codes(v, inv, n=7, b=0.0),
                           tref.ref_quantize_codes(v, inv, n=7, b=0.0))


SPLIT_CASES = [
    # (batch, h, w, cin, cout, ksize, bc): vector loader (cin % 16 == 0),
    # byte loader (cin 70; cin 48 at bc 24: kspan 216 % 16 != 0), a split
    # shorter than a stage, and DarkNet's late layers at B=1
    (2, 9, 7, 48, 37, 3, 16), (2, 9, 7, 48, 37, 3, 24),
    (3, 5, 5, 70, 67, 3, 35), (3, 5, 5, 70, 67, 3, 7),
    (1, 7, 7, 512, 1024, 3, 64), (1, 7, 7, 1024, 512, 1, 512),
    (1, 14, 14, 256, 512, 3, 64), (1, 6, 6, 64, 200, 1, 16)]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "x".join(
    map(str, c)))
@pytest.mark.parametrize("noise", [None, 1, 4])
@pytest.mark.parametrize("epilogue,lo", [("requant", -7), ("dequant", 0)])
def test_fq_conv2d_split_matches_plain(cuda, case, noise, epilogue, lo):
    b, h, w_, cin, cout, ks, bc = case
    rng = np.random.default_rng(cin + cout + bc)
    a = _codes(rng, (b, h, w_, cin), 0, 15, cuda)
    w = _codes(rng, (ks * ks * cin, cout), -7, 7, cuda)
    s = torch.tensor(np.float32(0.004), device=cuda)
    kw = dict(kh=ks, kw=ks, padding=(ks // 2, ks // 2), epilogue=epilogue,
              n_out=15, lo=lo,
              **({} if noise is None else _noise(cuda, 0.004, noise)))
    before = (fq_conv2d.launches, fq_conv2d.split_launches,
              splitk_epilogue.launches, fq_conv2d.vector_launches)
    got = fq_conv2d(a, w, s, bc=bc, **kw)
    torch.cuda.synchronize()
    want = tref.ref_fq_conv2d(a, w, s, **kw)
    assert torch.equal(got, want)
    split = cin // bc
    vector = cin % 16 == 0 and (ks * ks * bc) % 16 == 0
    assert (fq_conv2d.launches - before[0], fq_conv2d.split_launches
            - before[1], splitk_epilogue.launches - before[2],
            fq_conv2d.vector_launches - before[3]) == \
        (1, int(split > 1), int(split > 1), int(vector))
    assert torch.equal(fq_conv2d(a, w, s, bc=cin, **kw), want)


@pytest.mark.parametrize("split,m,n", [(2, 49, 1024), (8, 49, 1024),
                                       (3, 130, 45), (1, 7, 5)])
@pytest.mark.parametrize("noise", [None, 1, 4])
@pytest.mark.parametrize("epilogue", ["requant", "dequant"])
def test_splitk_epilogue_matches_plain(cuda, split, m, n, noise, epilogue):
    rng = np.random.default_rng(split * m + n)
    parts = torch.from_numpy(rng.integers(-60000, 60000, size=(
        split, m, n)).astype(np.int32)).to(cuda)
    s = torch.tensor(np.float32(1e-4), device=cuda)
    kw = dict(epilogue=epilogue, n_out=7, lo=-7,
              **({} if noise is None else _noise(cuda, 1e-4, noise)))
    got = splitk_epilogue(parts, s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.ref_splitk_epilogue(parts, s, **kw))


def test_split_conv_is_capturable(cuda):
    """The policy's split (DarkNet conv13 at B=1) inside a CUDA graph: the
    workspace comes from the graph's pool, replays equal the eager call."""
    rng = np.random.default_rng(13)
    a = _codes(rng, (1, 7, 7, 512), 0, 15, cuda)
    w = _codes(rng, (9 * 512, 1024), -1, 1, cuda)
    s = torch.tensor(np.float32(0.02), device=cuda)
    kw = dict(kh=3, kw=3, padding=(1, 1), n_out=7)
    want = fq_conv2d(a, w, s, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fq_conv2d(a, w, s, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = fq_conv2d.split_launches
    with torch.cuda.graph(graph):
        y = fq_conv2d(a, w, s, **kw)
    assert fq_conv2d.split_launches == before + 1
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, want)
    assert torch.equal(want, tref.ref_fq_conv2d(a, w, s, **kw))
