"""Boundary guards of the port.

* ``repro_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package ``repro``: checked in a fresh interpreter and by a source scan.
* Entry points run on CUDA unless ``device="cpu"`` is passed, and raise
  when there is no CUDA device.
* ``chip_smoke.py`` fails, and never reports success, on a machine without
  a CUDA device and in a directory that holds nothing else of the repo.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import interop
from repro_torch.core import integer_inference as tii
from repro_torch.core.quant import QuantConfig
from repro_torch.models import darknet as tdn
from repro_torch.models import kws as tkws
from repro_torch.models import resnet as tres

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        bad += [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_and_reference_unloaded():
    code = ("import sys, repro_torch.models.kws, repro_torch.interop, "
            "repro_torch.kernels.ops, repro_torch.models.darknet, "
            "repro_torch.core.distill, repro_torch.core.gradual, "
            "repro_torch.optim.sgd, repro_torch.optim.schedules, "
            "repro_torch.tree, repro_torch.taps, repro_torch.core.deploy_qat, "
            "repro_torch.train.trainer, repro_torch.data.synthetic, "
            "repro_torch.models.resnet, repro_torch.configs.paper_nets, "
            "repro_torch.serve.fleet, repro_torch.analysis.planlint, "
            "repro_torch.launch.mesh, repro_torch.models.fq_lm, "
            "repro_torch.serve.batching, repro_torch.serve.decode, "
            "repro_torch.kernels.lm_island, repro_torch.data.loader, "
            "repro_torch.optim.adam, repro_torch.optim.grad_compress, "
            "repro_torch.train.checkpoint, repro_torch.train.elastic, "
            "repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError):
        repro_torch.resolve_device("cuda")
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    assert not repro_torch.has_cuda()


def test_resolve_device_rejects_other_backends():
    with pytest.raises(ValueError):
        repro_torch.resolve_device("meta")


def test_entry_points_raise_without_cuda(no_cuda):
    cfg = tkws.KWSConfig.reduced()
    with pytest.raises(RuntimeError):
        tkws.init(torch.Generator().manual_seed(0), cfg)
    params, state = tkws.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    assert params["conv0"]["w"].device.type == "cpu"
    np_params = {"conv0": {"w": np.zeros((3, 2, 2), np.float32)}}
    with pytest.raises(RuntimeError):
        interop.params_from_numpy(np_params, {})
    p, _ = interop.params_from_numpy(np_params, {}, device="cpu")
    assert p["conv0"]["w"].device.type == "cpu"
    with pytest.raises(RuntimeError):
        interop.stack_from_numpy({}, {}, QuantConfig(2, 4, 4, True), [])


def test_darknet_entry_points_raise_without_cuda(no_cuda):
    cfg = tdn.DarkNetConfig.reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdn.init(torch.Generator().manual_seed(0), cfg)
    params, state = tdn.init(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    assert params["conv1"]["w"].device.type == "cpu"
    params = tii.sync_handoff(tdn.to_fq(params, state, cfg),
                              tdn.int_conv_names(cfg))
    stack = tdn.convert_int(params, state, QuantConfig(2, 4, 4, True), cfg)
    with pytest.raises(RuntimeError):
        stack.to(repro_torch.resolve_device())
    logits = tdn.int_serve_fn(stack, QuantConfig(2, 4, 4, True), cfg)(
        np.zeros((1, 16, 16, 3), np.float32))
    assert logits.device.type == "cpu" and logits.shape == (1, 16)


def test_resnet_entry_points_raise_without_cuda(no_cuda):
    cfg = tres.ResNetConfig.reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tres.init(torch.Generator().manual_seed(0), cfg)
    params, state = tres.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    leaves = [t for tree_ in (params, state) for d in tree_.values()
              for t in d.values()]
    assert len(leaves) > 0 and all(t.device.type == "cpu" for t in leaves)
    logits, _ = tres.apply(params, state, torch.zeros(1, 16, 16, 3),
                           QuantConfig(), cfg)
    assert logits.device.type == "cpu" and logits.shape == (1, 10)


def test_lm_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.models import fq_lm
    cfg = fq_lm.FQLMConfig.reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fq_lm.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fq_lm.init_caches(cfg, 2, 8)
    p = fq_lm.standin_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    stack = fq_lm.convert_int(p, cfg, fq_lm.LM_QCFG)
    assert stack.device.type == "cpu"
    out = fq_lm.int_generate(stack, [1, 2], fq_lm.LM_QCFG, cfg, max_new=2,
                             max_len=8)
    assert len(out) == 2


def test_train_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.configs import get_arch
    from repro_torch.data import loader, synthetic
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adam, schedules
    from repro_torch.train import trainer
    argv = ["--arch", "minicpm-2b", "--smoke", "--steps", "1", "--batch",
            "2", "--seq", "4"]
    with pytest.raises(RuntimeError):
        launch_train.main(argv)
    cfg = loader.LoaderConfig(2, 4, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.SyntheticLMLoader(cfg, synthetic.lm_batch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.batch_key(0, 1)
    b = loader.SyntheticLMLoader(cfg, synthetic.lm_batch,
                                 device="cpu").batch_at(0)
    assert b["tokens"].device.type == "cpu"
    arch = get_arch("minicpm-2b")
    opt = adam.make(schedules.constant(1e-3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.make_train_step(arch.smoke, arch.qcfg, opt)
    trainer.make_train_step(arch.smoke, arch.qcfg, opt, device="cpu")
    assert launch_train.main(argv + ["--device", "cpu", "--log-every",
                                     "1"]) == 0


def _run_smoke(cwd, script, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    r = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    r = _run_smoke(tmp_path, lone)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
