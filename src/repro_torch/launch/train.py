"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Counterpart of ``repro.launch.train``, with the reference's flags and its
``[train] step N loss ...`` lines, wiring:

  data/loader (deterministic, coordinator-free)
   -> train/trainer (grad accumulation + clipping)
   -> optim/adam | sgd (+ WSD for minicpm-2b, cosine otherwise; optional
      int8 moments)
   -> train/checkpoint (atomic, keep-k, resumable)
   -> train/elastic (watchdog -> the checkpoint-restart path)

It runs on the card (``--device cuda``, the default); ``--device cpu`` runs
the plain PyTorch path. ``--mesh`` raises: meshes come with the mesh slice.

On the CPU, the smoke config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --smoke --steps 30 --batch 8 --seq 64 --device cpu

The parameters are drawn from a ``torch.Generator`` seeded with ``--seed``
(the reference draws from ``jax.random.key(seed)``: other numbers).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from ..configs import ARCH_IDS, get_arch
from ..core import prng
from ..core.quant import QuantConfig
from ..data import synthetic
from ..data.loader import LoaderConfig, SyntheticLMLoader, batch_key
from ..device import resolve_device
from ..models import transformer as T
from ..optim import adam, schedules, sgd
from ..train import checkpoint, trainer
from ..train.elastic import StepWatchdog


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default=None,
                    choices=[None, "cosine", "wsd", "constant"])
    ap.add_argument("--opt", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--moment-bits", type=int, default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2,2' => (data,model); not yet supported")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--watchdog-s", type=float, default=600.0)
    ap.add_argument("--bits", default=None,
                    help="QAT stage 'W,A' e.g. '8,8' or '2,5'")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv)


def init_params(seed: int, cfg, device):
    """The model's parameters, drawn from a generator seeded with ``seed``
    on ``device``."""
    return T.make_params(torch.Generator(device=device).manual_seed(seed),
                         cfg, device=device)


class TrainRun:
    """One launcher run, set up from its flags: ``run()`` is the loop that
    ``main`` runs; ``step_once(step)`` one step of it."""

    def __init__(self, args: argparse.Namespace):
        if args.mesh:
            raise NotImplementedError(
                "--mesh: meshes come with the mesh slice of the port")
        self.args = args
        self.device = dev = resolve_device(args.device)
        arch = get_arch(args.arch)
        self.cfg = cfg = arch.smoke if args.smoke else arch.model
        self.qcfg = arch.qcfg
        if args.bits:
            w, a = (int(x) for x in args.bits.split(","))
            self.qcfg = QuantConfig(w, a)

        # ---- schedule / optimizer --------------------------------------
        sched = args.schedule or (
            "wsd" if args.arch == "minicpm-2b" else "cosine")
        if sched == "wsd":
            lr_fn = schedules.wsd(args.lr, args.steps)
        elif sched == "constant":
            lr_fn = schedules.constant(args.lr)
        else:
            lr_fn = schedules.cosine(args.lr, args.steps,
                                     warmup=args.steps // 20)
        self.schedule = sched
        if args.opt == "sgd":
            self.opt = sgd.make(lr_fn, weight_decay=5e-4)
        else:
            self.opt = adam.make(lr_fn, weight_decay=0.1,
                                 moment_bits=args.moment_bits)

        # ---- params / state --------------------------------------------
        self.params = init_params(args.seed, cfg, dev)
        self.opt_state = self.opt.init(self.params)
        self.start_step = 0
        if args.resume and args.ckpt_dir and \
                checkpoint.latest_step(args.ckpt_dir) is not None:
            self.start_step, self.params, self.opt_state, _ = \
                checkpoint.restore(args.ckpt_dir, self.params,
                                   self.opt_state)
            print(f"[train] resumed from step {self.start_step}")

        tc = trainer.TrainConfig(grad_accum=args.grad_accum)
        self.step_fn = trainer.make_train_step(cfg, self.qcfg, self.opt, tc,
                                               device=dev)
        self.loader = SyntheticLMLoader(
            LoaderConfig(args.batch, args.seq, cfg.vocab, seed=args.seed),
            synthetic.lm_batch, device=dev)

    def batch_at(self, step: int):
        b = self.loader.batch_at(step)
        fe = self.cfg.frontend
        if fe.enabled:
            k = batch_key(self.args.seed + 1, step, device=self.device)
            b = dict(b, feats=prng.normal(
                k, (self.args.batch, fe.n_positions, fe.feat_dim)))
        return b

    def step_once(self, step: int):
        """One train step on the step's batch; returns its metrics."""
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, self.batch_at(step), step)
        return metrics

    def run(self, on_step: Optional[Callable] = None) -> int:
        """The reference's loop; ``on_step(step, metrics)`` after each
        step."""
        args = self.args
        watchdog = StepWatchdog(args.watchdog_s)
        t0 = time.time()
        for step in range(self.start_step, args.steps):
            metrics = self.step_once(step)
            if on_step is not None:
                on_step(step, metrics)
            if watchdog.tick():
                print("[train] watchdog tripped -> checkpoint-restart path")
                if args.ckpt_dir:
                    checkpoint.save(args.ckpt_dir, step, self.params,
                                    self.opt_state)
                break
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"({time.time()-t0:.1f}s)")
            if args.ckpt_dir and step > 0 and step % args.ckpt_every == 0:
                checkpoint.save(args.ckpt_dir, step, self.params,
                                self.opt_state, extra={"arch": args.arch})
        if args.ckpt_dir:
            checkpoint.save(args.ckpt_dir, args.steps, self.params,
                            self.opt_state, extra={"arch": args.arch})
            print(f"[train] final checkpoint at step {args.steps}")
        return 0


def main(argv=None) -> int:
    return TrainRun(parse_args(argv)).run()


if __name__ == "__main__":
    raise SystemExit(main())
