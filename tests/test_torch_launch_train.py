"""The training launcher of the port (``python -m repro_torch.launch.train``)
against the reference's (``repro.launch.train``).

Both launchers run the same flags on the same params (the reference's,
carried across by ``interop``: the port's own init draws other numbers),
with remat off on both sides, the port's quantizers pinned to the
reference's step by step (``repro_torch.taps``, as in
``tests/torch_zoo_ref.py``). Each step's loss and global norm agree within
1e-5 relative, and so do the ``[train] step`` lines (printed to 4
decimals: within one unit of the last). A resumed run continues from the
manifest's step with the straight run's losses; ``--mesh`` raises.
"""
import contextlib
import dataclasses
import io
import re
from unittest import mock

import jax
import numpy as np
import pytest

import torch_zoo_ref as Z
from repro.configs import get_arch as jget_arch
from repro.launch import train as JL
from repro.models import transformer as JT
from repro.train import trainer as JTR
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.launch import train as TL
from repro_torch.taps import Taps, recorded

one_thread = Z.one_thread
LINE = re.compile(r"\[train\] step +(\d+) loss (\S+) ")


def _no_remat(arch):
    return dataclasses.replace(arch, smoke=dataclasses.replace(
        arch.smoke, remat=False))


def reference_run(arch_id, argv):
    """(printed lines, [(loss, grad_norm)] a step, the quantizer inputs of
    each step, the init params as numpy) of the reference's launcher."""
    arch = _no_remat(jget_arch(arch_id))
    steps, calls = [], []
    orig = JTR.jit_train_step

    def jit_train_step(*a, **kw):
        fn, specs = orig(*a, **kw)

        def step(*args):
            n0 = len(rec)
            out = fn(*args)
            jax.block_until_ready(out)
            jax.effects_barrier()
            calls.append(rec[n0:])
            steps.append((float(out[2]["loss"]), float(out[2]["grad_norm"])))
            return out
        return step, specs

    # eager, as the launcher draws them (jitted, a few values differ by an
    # ulp, and Adam's first steps magnify that)
    params = jax.tree.map(np.asarray, JT.make_params(jax.random.key(0),
                                                     arch.smoke))
    out = io.StringIO()
    with Z.reference_taps() as rec, \
            mock.patch.object(JTR, "jit_train_step", jit_train_step), \
            mock.patch.object(JL, "get_arch", lambda _: arch), \
            contextlib.redirect_stdout(out):
        assert JL.main(argv) == 0
    return out.getvalue(), steps, calls, params


def port_run(arch_id, argv, params, calls=None):
    """(printed lines, [(loss, grad_norm)] a step, the code flips and
    rounding ties a step) of the port's launcher on ``params``, pinned to
    the reference's ``calls`` when given."""
    arch = _no_remat(get_arch(arch_id))
    steps, flips = [], []
    out = io.StringIO()
    with mock.patch.object(TL, "get_arch", lambda _: arch), \
            mock.patch.object(TL, "init_params", lambda seed, cfg, dev:
                              interop.params_from_numpy(params, {},
                                                        device=dev)[0]), \
            contextlib.redirect_stdout(out):
        run = TL.TrainRun(TL.parse_args(argv + ["--device", "cpu"]))
        if calls is not None:
            fn = run.step_fn

            def pinned(p, s, b, i):
                taps = Taps(recorded(calls=calls[i - run.start_step]))
                with taps:
                    res = fn(p, s, b, i)
                taps.matched()
                flips.append((taps.code_flips, taps.round_ties))
                return res
            run.step_fn = pinned
        assert run.run(on_step=lambda i, m: steps.append(
            (float(m["loss"]), float(m["grad_norm"])))) == 0
    return out.getvalue(), steps, flips


def _lines(text):
    return [(int(s), float(v)) for s, v in LINE.findall(text)]


def _assert_same_run(ref, port, n):
    (jtext, jsteps), (ttext, tsteps) = ref, port
    assert len(jsteps) == len(tsteps) == n
    for (jl, jg), (tl, tg) in zip(jsteps, tsteps):
        assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
        assert abs(tg - jg) <= 1e-5 * abs(jg), (tg, jg)
    jl, tl = _lines(jtext), _lines(ttext)
    assert [s for s, _ in jl] == [s for s, _ in tl] == list(range(n))
    assert all(abs(a - b) <= 1e-4 for (_, a), (_, b) in zip(jl, tl))


@pytest.mark.parametrize("arch_id,steps,extra", [
    ("minicpm-2b", 5, []),
    ("deepseek-v2-lite-16b", 5, []),
    # int8 moments: most of v's codes round to 0 under one abs-max scale, so
    # steps of lr / eps make the run chaotic after a few steps (both
    # packages alike); 3 steps keep it comparable
    ("minicpm-2b", 3, ["--moment-bits", "8", "--grad-accum", "2",
                       "--schedule", "cosine"]),
], ids=["minicpm-2b-wsd", "deepseek-v2-lite-16b-cosine",
        "minicpm-2b-int8-accum2"])
def test_losses_match_reference(arch_id, steps, extra):
    argv = ["--arch", arch_id, "--smoke", "--steps", str(steps), "--batch",
            "4", "--seq", "16", "--log-every", "1"] + extra
    jtext, jsteps, calls, params = reference_run(arch_id, argv)
    ttext, tsteps, flips = port_run(arch_id, argv, params, calls)
    _assert_same_run((jtext, jsteps), (ttext, tsteps), steps)
    # the first step starts from the same params: its flips are ties
    assert flips[0][0] == flips[0][1], flips


def test_resume_continues_from_the_manifest(tmp_path):
    """--steps 2 with a checkpoint, then --steps 4 --resume: the resumed run
    starts at the manifest's step 2 and gives the straight 4-step run's
    losses bit for bit (constant lr: the schedule does not depend on
    --steps)."""
    params = jax.tree.map(np.asarray, JT.make_params(
        jax.random.key(0), jget_arch("minicpm-2b").smoke))
    base = ["--arch", "minicpm-2b", "--smoke", "--batch", "4", "--seq", "8",
            "--log-every", "1", "--schedule", "constant", "--moment-bits",
            "8"]
    _, straight, _ = port_run("minicpm-2b", base + ["--steps", "4"], params)
    ck = ["--ckpt-dir", str(tmp_path)]
    text, first, _ = port_run("minicpm-2b", base + ["--steps", "2"] + ck,
                              params)
    assert "[train] final checkpoint at step 2" in text
    text, rest, _ = port_run("minicpm-2b", base + ["--steps", "4", "--resume"]
                             + ck, params)
    assert "[train] resumed from step 2" in text
    assert [s for s, _ in _lines(text)] == [2, 3]
    assert first + rest == straight


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="mesh slice"):
        TL.main(["--arch", "minicpm-2b", "--smoke", "--steps", "1",
                 "--mesh", "2,2", "--device", "cpu"])
