"""Checkpoint / restart on the port (``train.checkpoint``): the reference's
``tests/test_checkpoint.py`` cases, and files that cross between the
packages.

* round trip (int8 moment codes stay int8), keep-k, no ``.tmp`` left, a
  specific step, and a resume bit-identical with a straight run;
* a file the reference writes restores in the port, and one the port
  writes restores in the reference, leaf for leaf and bit for bit, with
  the reference's array names;
* bfloat16 leaves round-trip without ml_dtypes, as 2-byte words the
  reference reads as its own.
"""
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.optim import adam as jadam
from repro.optim import schedules as jsched
from repro.train import checkpoint as jckpt
from repro_torch import interop, tree
from repro_torch.core import prng
from repro_torch.core.quant import QuantConfig
from repro_torch.data import synthetic
from repro_torch.models import transformer as T
from repro_torch.optim import adam, schedules
from repro_torch.train import checkpoint, trainer

CFG = T.TransformerConfig(
    name="tiny", n_layers=2, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32,
    vocab=32, param_dtype=torch.float32, max_seq=64)
JCFG = JT.TransformerConfig(
    name="tiny", n_layers=2, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32,
    vocab=32, param_dtype=jnp.float32, max_seq=64)


def _params(seed=0):
    return T.make_params(torch.Generator().manual_seed(seed), CFG,
                         device="cpu")


def _same(a, b):
    la, lb = tree.named_leaves(a), tree.named_leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert torch.equal(x, y), n


def test_roundtrip(tmp_path):
    params = _params()
    opt = adam.make(schedules.constant(1e-3), moment_bits=8)
    st = opt.init(params)
    checkpoint.save(str(tmp_path), 7, params, st, extra={"stage": "Q88"})
    step, p2, s2, extra = checkpoint.restore(str(tmp_path), params, st)
    assert step == 7 and extra == {"stage": "Q88"}
    _same(params, p2)
    _same(st, s2)
    assert s2["mom"]["final_norm"]["scale"]["m"].dtype == torch.int8
    assert s2["count"].dtype == torch.int32


def test_keep_k(tmp_path):
    params = {"w": torch.zeros(3)}
    for s in range(5):
        checkpoint.save(str(tmp_path), s, params, keep=2)
    files = sorted(os.listdir(tmp_path))
    assert files == ["proc0_step_000000003.npz", "proc0_step_000000004.npz"]
    assert checkpoint.latest_step(str(tmp_path)) == 4
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), params)


def test_no_tmp_left_behind(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"w": torch.ones(2)})
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_restore_specific_step(tmp_path):
    for s in (1, 2, 3):
        checkpoint.save(str(tmp_path), s, {"w": torch.full((2,), float(s))},
                        keep=5)
    step, p, _, _ = checkpoint.restore(str(tmp_path), {"w": torch.zeros(2)},
                                       step=2)
    assert step == 2 and float(p["w"][0]) == 2.0


def test_restore_checks_the_template(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="template"):
        checkpoint.restore(str(tmp_path),
                           {"w": torch.zeros(2, dtype=torch.float64)})
    # a meta template gives CPU tensors
    _, p, _, _ = checkpoint.restore(str(tmp_path),
                                    {"w": torch.empty(2, device="meta")})
    assert p["w"].device.type == "cpu" and torch.equal(p["w"], torch.ones(2))


def test_resume_bit_identical_training(tmp_path):
    """6 steps straight against 3 + save + restore + 3: identical params
    and state (the determinism contract of restart)."""
    opt = adam.make(schedules.constant(1e-3), moment_bits=8)
    step_fn = trainer.make_train_step(CFG, QuantConfig(8, 8), opt,
                                      trainer.TrainConfig(), device="cpu")

    def batch_at(i):
        return synthetic.lm_batch(prng.fold_in(prng.PRNGKey(0), i), batch=4,
                                  seq_len=16, vocab=CFG.vocab)

    p, s = _params(5), opt.init(_params(5))
    for i in range(6):
        p, s, _ = step_fn(p, s, batch_at(i), i)
    p2, s2 = _params(5), opt.init(_params(5))
    for i in range(3):
        p2, s2, _ = step_fn(p2, s2, batch_at(i), i)
    checkpoint.save(str(tmp_path), 3, p2, s2)
    _, p3, s3, _ = checkpoint.restore(str(tmp_path), p2, s2)
    for i in range(3, 6):
        p3, s3, _ = step_fn(p3, s3, batch_at(i), i)
    _same(p, p3)
    _same(s, s3)


def _reference_files(tmp_path, bits):
    """The reference's params and Adam state (two updates in), saved by the
    reference; returns (dir, params, state) as numpy trees."""
    jp = JT.make_params(jax.random.key(3), JCFG)
    jopt = jadam.make(jsched.constant(1e-2), weight_decay=0.1,
                      moment_bits=bits)
    js = jopt.init(jp)
    rng = np.random.default_rng(0)
    for i in range(2):
        g = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape), x.dtype), jp)
        jp, js = jopt.update(jp, g, js, jnp.int32(i))
    d = str(tmp_path / "ref")
    jckpt.save(d, 2, jp, js, extra={"arch": "tiny"})
    return d, jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)


@pytest.mark.parametrize("bits", [None, 8])
def test_reference_file_restores_in_the_port(tmp_path, bits):
    d, jp, js = _reference_files(tmp_path, bits)
    tp = interop.params_from_numpy(jp, {}, device="cpu")[0]
    ts = interop.opt_state_from_numpy(js, device="cpu")
    template_p = tree.map(torch.zeros_like, tp)
    template_s = tree.map(torch.zeros_like, ts)
    step, p, s, extra = checkpoint.restore(d, template_p, template_s)
    assert step == 2 and extra == {"arch": "tiny"}
    _same(tp, p)
    _same(ts, s)


@pytest.mark.parametrize("bits", [None, 8])
def test_port_file_restores_in_the_reference(tmp_path, bits):
    d, jp, js = _reference_files(tmp_path, bits)
    tp = interop.params_from_numpy(jp, {}, device="cpu")[0]
    ts = interop.opt_state_from_numpy(js, device="cpu")
    pd = str(tmp_path / "port")
    checkpoint.save(pd, 2, tp, ts, extra={"arch": "tiny"})
    with zipfile.ZipFile(os.path.join(d, "proc0_step_000000002.npz")) as a, \
            zipfile.ZipFile(os.path.join(pd, "proc0_step_000000002.npz")) \
            as b:
        assert a.namelist() == b.namelist()
    step, p, s, extra = jckpt.restore(pd, jp, js)
    assert step == 2 and extra == {"arch": "tiny"}
    for x, y in zip(jax.tree.leaves((jp, js)), jax.tree.leaves((p, s))):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_bfloat16_leaves(tmp_path):
    """bfloat16 leaves: the port's file holds the reference's ``<V2``
    words, restores bit for bit in the port and reads in the reference as
    the reference's own file does; the reference's file restores in the
    port."""
    w = torch.randn(5, 3, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    w[0, 0] = float("inf")
    w[0, 1] = -0.0
    pd, jd = str(tmp_path / "port"), str(tmp_path / "ref")
    checkpoint.save(pd, 1, {"w": w, "b": torch.ones(2)})
    _, p, _, _ = checkpoint.restore(pd, {"w": torch.empty(5, 3,
                                                         dtype=torch.bfloat16),
                                         "b": torch.empty(2)})
    assert p["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"].view(torch.int16), w.view(torch.int16))
    jw = jnp.asarray(w.view(torch.int16).numpy()).view(jnp.bfloat16)
    jckpt.save(jd, 1, {"w": jw, "b": jnp.ones(2)})
    with np.load(os.path.join(pd, "proc0_step_000000001.npz")) as a, \
            np.load(os.path.join(jd, "proc0_step_000000001.npz")) as b:
        assert a["p/w"].dtype == b["p/w"].dtype
        assert a["p/w"].tobytes() == b["p/w"].tobytes()
    _, p, _, _ = checkpoint.restore(jd, {"w": torch.empty(
        5, 3, dtype=torch.bfloat16), "b": torch.empty(2)})
    assert torch.equal(p["w"].view(torch.int16), w.view(torch.int16))


def test_bfloat16_without_ml_dtypes(tmp_path):
    """In a fresh interpreter where ml_dtypes cannot be imported, a
    bfloat16 leaf saves and restores bit for bit."""
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.train import checkpoint\n"
        "w = torch.arange(12, dtype=torch.float32).reshape(3, 4)"
        ".div(7).to(torch.bfloat16)\n"
        f"checkpoint.save({str(tmp_path)!r}, 1, {{'w': w}})\n"
        f"_, p, _, _ = checkpoint.restore({str(tmp_path)!r}, "
        "{'w': torch.empty(3, 4, dtype=torch.bfloat16)})\n"
        "assert torch.equal(p['w'].view(torch.int16), w.view(torch.int16))\n"
        "assert 'ml_dtypes' not in sys.modules or "
        "sys.modules['ml_dtypes'] is None\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
