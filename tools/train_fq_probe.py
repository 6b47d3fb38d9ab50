#!/usr/bin/env python3
"""Card against CPU at the FQ transition of ``chip_smoke.py``'s ResNet-32
``train_fq`` row, with the CPU's inputs to each step taken several ways.

``chip_smoke.py`` repeats every training step of the card on the CPU from
the card's params, state and momentum, the CPU's discrete choices pinned to
the card's (``repro_torch.taps``). This script runs the row's ladder (FP,
Q and the first FQ stage, as ``train_fq`` runs them: the same data, seeds,
seeding of the weight scales, schedule and teacher) on the card alone at
each learning rate of ``--lr``. At the FQ transition it prints the
calibration's code flips per quantizer (how many are rounding ties, and
how many of the card's inputs lie on a half-LSB boundary). At each FQ step
it repeats the step on the CPU with the teacher's logits taken:

* ``unpinned``: the CPU's own teacher forward, its choices free;
* ``pinned``: the CPU's teacher forward pinned to the card's choices;
* ``card``: the card's teacher logits, copied;
* ``card+head``: the card's teacher logits and the card's gradient of the
  loss by the logits, so that the network below the head is compared
  alone;

and prints, for each way, the teacher logits' difference, the flips of
the teacher's forward, and the worst log-scale / BN gradient error over
its magnitude M (``chip_smoke.TRAIN_C_S`` is the bound) with the leaves
past it; then, for the update of each side from its own gradients, the
largest log-scale move, the non-finite leaves and the loss at the updated
params. ``--ways`` picks the CPU's ways; ``--ladder table`` runs Table 6's
whole ladder up to its FQ stage. ``--save DIR`` writes the first FQ
step's params, state, batch, teacher logits and the card's log-scale and
head gradients of the first ``--lr`` as ``.npz``, which
``tests/train_fq_reference_hold.py`` reads.

Run on a CUDA machine from the repo root (~2 min a rate for ResNet-32)::

    python3 tools/train_fq_probe.py --lr 0.05 0.001
"""
from __future__ import annotations

import argparse
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402


WAYS = ("unpinned", "pinned", "card", "card+head")


def quantizer_names(params):
    """{id(log-scale leaf): "layer.s_*"} of a param tree."""
    return {id(v): f"{n}.{k}" for n, d in params.items()
            if isinstance(d, dict) for k, v in d.items()
            if k.startswith("s_")}


def call_taps(torch, taps, quant):
    """A :class:`repro_torch.taps.Taps` that also lists, per quantizer call
    with code flips, the flips, the rounding ties among them and the share
    of the reference's inputs that lie on a half-LSB boundary; and keeps
    the gradient of the loss by each quantizer's output (``grads``)."""

    class CallTaps(taps.Taps):
        names: dict = {}  # {id(s): name} where no paths are set

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.per_call, self.grads = [], {}

        def quantize(self, x, s, *, bits, b, stabilize=True):
            i = self.count["calls"]
            name = self.paths.get(id(s)) or self.names.get(id(s), "?")
            before = (self.code_flips, self.round_ties)
            q = super().quantize(x, s, bits=bits, b=b, stabilize=stabilize)
            if q.requires_grad:
                q.register_hook(lambda gq, i=i: self.grads.__setitem__(
                    i, (name, gq.detach())))
            flips = self.code_flips - before[0]
            if flips and self.ref is not None:
                n = quant.n_levels(bits)
                g = 1.0 / math.sqrt(max(x.numel(), 1) * n)
                sd = s.detach()
                e = quant.exp(quant._grad_scale(sd, g) if stabilize else sd)
                ref = self.ref.calls[i].to(x.device)
                _, _, u = taps.category(ref, e.to(ref.dtype), b, n)
                half = (u - torch.floor(u) - 0.5).abs() <= (
                    taps.ROUND_TIE_EPS * torch.clamp(u.abs(), min=1.0))
                self.per_call.append(dict(
                    call=i, name=name, bits=bits,
                    positions=x.numel(), flips=flips,
                    round_ties=self.round_ties - before[1],
                    on_half=float(half.float().mean()),
                    e=float(e)))
            return q
    return CallTaps


def compare_upstream(torch, card, cpu):
    """Per quantizer call, the gradients of the loss by its output, card
    against CPU: the calls whose relative L2 difference passes 1e-3 (float32
    rounding reads ~1e-6), in call order."""
    out = []
    for i in sorted(cpu):
        name, gc = cpu[i]
        g = card[i][1].cpu()
        rel = float((g - gc).norm()) / max(float(gc.norm()), 1e-30)
        support = int(((g != 0) != (gc != 0)).sum())
        if rel > 1e-3:
            big = (g - gc).abs().flatten().argmax()
            out.append(f"call {i} {name}: rel L2 {rel:.3g}, positions "
                       f"nonzero on one side only {support}, largest "
                       f"|diff| {float((g - gc).abs().max()):.3g} (card "
                       f"{float(g.flatten()[big]):.3g}, CPU "
                       f"{float(gc.flatten()[big]):.3g})")
    return out


def compare(torch, card, cpu, mag):
    """(worst |diff| / M and its leaf, leaves past TRAIN_C_S x M, worst
    weight rel L2 and its leaf) of two gradient dicts."""
    worst_s, worst_w, past = (0.0, ""), (0.0, ""), []
    for name, gc in cpu.items():
        g = card[name].cpu()
        err = float((g - gc).norm())
        if name in mag:
            m = mag[name]
            r = err / m if m else (0.0 if err == 0 else math.inf)
            worst_s = max(worst_s, (r, name))
            if err > cs.TRAIN_C_S * m:
                past.append(f"{name} {r:.3g}")
        else:
            r = err / float(gc.norm()) if gc.norm() > 0 else err
            worst_w = max(worst_w, (r, name))
    return worst_s, past, worst_w


def run(torch, dev, path, lr, save, ways=None, ladder="smoke"):
    import numpy as np
    from repro_torch import taps, tree
    from repro_torch.core import distill, gradual, quant
    from repro_torch.core import fq_layers as fql
    from repro_torch.core import integer_inference as ii
    from repro_torch.core.quant import QuantConfig
    from repro_torch.optim import schedules, sgd

    CallTaps = call_taps(torch, taps, quant)
    ways = WAYS if ways is None else ways
    setup = cs.train_setup(path)
    model, cfg, shape = setup["model"], setup["cfg"], setup["shape"]
    quantized = setup["quantized"]
    stages = setup["stages"][:3]  # FP, Q, the first FQ stage
    if ladder == "table":
        # the ladder's every stage up to its first FQ one
        from repro_torch.configs.paper_nets import PAPER_NETS, ladder_for
        table = ladder_for(PAPER_NETS["resnet32-cifar100"])
        table = table[:next(i for i, q in enumerate(table) if q.fq) + 1]
        stages = [(q, "FP" if q.is_fp else q.label(), False) for q in table]
    batch = shape[0]
    rng = np.random.default_rng(cs.SEED + 7)   # train_model's batch
    x_np = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    y_np = rng.integers(0, cfg.num_classes, batch)
    devs = {"card": dev, "cpu": torch.device("cpu")}
    data = {d: (torch.from_numpy(x_np).to(v), torch.from_numpy(y_np).to(v))
            for d, v in devs.items()}
    tag = f"probe {path} lr {lr}"

    def loss_fn(d, qcfg, state, teacher_logits):
        x, y = data[d]

        def fn(p):
            logits, new = model.apply(p, state, x, qcfg, cfg, train=True)
            if teacher_logits is None:
                onehot = torch.nn.functional.one_hot(
                    y, cfg.num_classes).float()
                loss = torch.mean(distill.softmax_cross_entropy(logits,
                                                                onehot))
            else:
                loss = distill.distillation_loss(logits, teacher_logits, y,
                                                 alpha=cs.TRAIN_ALPHA)
            return loss, (logits, new)
        return fn

    def head_grad(fn, params):
        """dL/dlogits of ``fn`` at ``params``."""
        with torch.enable_grad():
            live = tree.map(lambda t: t.detach().requires_grad_(True),
                            params)
            loss, (logits, _) = fn(live)
            return torch.autograd.grad(loss, logits)[0]

    def body_value_and_grad(fn, params, t, g_head):
        """As ``taps.value_and_grad``, the backward started at the logits
        from ``g_head``."""
        named = tree.named_leaves(params)
        live = [v.detach().requires_grad_(True) for _, v in named]
        t.paths = {id(v): k for (k, _), v in zip(named, live)}
        with t, torch.enable_grad():
            loss, (logits, new) = fn(tree.unflatten(params, live))
            grads = torch.autograd.grad(logits, live, grad_outputs=g_head,
                                        allow_unused=True)
        return (loss.detach(), (logits, new)), {
            k: torch.zeros_like(v) if g is None else g
            for (k, _), v, g in zip(named, live, grads)}

    def calibrate_probe(p, st, qcfg):
        """to_fq + calibrate on the card (recorded) and on the CPU (pinned,
        per call listed); returns the card's params."""
        folded, card_taps = {}, []
        for d, v in devs.items():
            pd, sd = ii.to_device(p, v), ii.to_device(st, v)
            pd = model.to_fq(pd, sd, cfg)
            if cs.sw_seeded(path, "fq"):
                pd = cs.seed_weight_scales(pd, quantized)
            refs = iter(list(card_taps))
            it = [0]

            def forward(pp, sd=sd, d=d, refs=refs, it=it):
                CallTaps.names = quantizer_names(pp)
                with CallTaps(None if d == "card" else next(refs),
                              record=d == "card") as t:
                    model.apply(pp, sd, data[d][0], qcfg, cfg)
                if d == "card":
                    card_taps.append(t)
                else:
                    print(f"{tag}: calibrate forward {it[0]}: code flips "
                          f"{t.code_flips} of {t.positions} "
                          f"({t.code_flips / max(t.positions, 1):.3g}), "
                          f"rounding ties {t.round_ties}, tie flips "
                          f"{t.tie_flips}", flush=True)
                    for c in t.per_call:
                        print(f"{tag}:   call {c['call']} {c['name']} "
                              f"A{c['bits']} e {c['e']:.6g}: {c['flips']} "
                              f"flips of {c['positions']}, "
                              f"{c['round_ties']} rounding ties; share of "
                              f"the card's inputs on a half-LSB boundary "
                              f"{c['on_half']:.3g}", flush=True)
                it[0] += 1
            folded[d] = fql.calibrate(forward, pd, iters=cs.TRAIN_CAL_ITERS)
        return folded["card"]

    def teacher_logits(teacher):
        """The teacher's logits: the card's (its choices recorded), the
        CPU's unpinned and pinned, and the pinned forward's flips."""
        tp, ts, tq = teacher
        with torch.no_grad(), taps.Taps(record=True) as tc:
            card, _ = model.apply(tp, ts, data["card"][0], tq, cfg)
        cp, cst = ii.to_device(tp, "cpu"), ii.to_device(ts, "cpu")
        with torch.no_grad():
            free, _ = model.apply(cp, cst, data["cpu"][0], tq, cfg)
        with torch.no_grad(), taps.Taps(tc) as tp_:
            pinned, _ = model.apply(cp, cst, data["cpu"][0], tq, cfg)
        tp_.matched()
        c = card.cpu()
        print(f"{tag}: teacher {tq.label()}: max|logit| "
              f"{float(c.abs().max()):.6g}; |card - CPU| unpinned "
              f"{float((c - free).abs().max()):.3g}, pinned "
              f"{float((c - pinned).abs().max()):.3g}; the CPU's teacher "
              f"forward against the card's: code flips {tp_.code_flips}, "
              f"tie flips {tp_.tie_flips} of {tp_.positions}, ReLU flips "
              f"{tp_.relu_flips} of {tp_.relu_positions}", flush=True)
        return {"card": card, "unpinned": free, "pinned": pinned}

    def fq_step(p, st, qcfg, t_log, i):
        """The card's step, and the CPU's taken each way of ``ways``;
        returns the card's (value, grads) and the CPU's grads of the last
        way."""
        fn = loss_fn("card", qcfg, st, t_log["card"])
        tc = CallTaps(record=True)
        res = taps.value_and_grad(fn, p, tc)
        (l_card, (lg_card, new)), g_card = res
        g_head = head_grad(fn, p)
        cp, cst = ii.to_device(p, "cpu"), ii.to_device(st, "cpu")
        g = None
        for way in ways:
            tl = t_log["card" if way.startswith("card") else way].cpu()
            f = loss_fn("cpu", qcfg, cst, tl)
            t = CallTaps(tc)
            if way == "card+head":
                (l, (lg, _)), g = body_value_and_grad(f, cp, t,
                                                      g_head.cpu())
            else:
                (l, (lg, _)), g = taps.value_and_grad(f, cp, t)
            t.matched()
            ws, past, ww = compare(torch, g_card, g, t.mag)
            for name in [v.split()[0] for v in past[:3]]:
                print(f"{tag}:   {name}: M CPU {t.mag[name]:.6g}, card "
                      f"{tc.mag.get(name, 0.0):.6g}; |grad| card "
                      f"{float(g_card[name].norm()):.6g}, CPU "
                      f"{float(g[name].norm()):.6g}", flush=True)
            for line in compare_upstream(torch, tc.grads, t.grads)[:12]:
                print(f"{tag}:   {way}: {line}", flush=True)
            dl = float((lg_card.detach().cpu() - lg.detach()).abs().max())
            print(f"{tag}: {qcfg.label()} step {i} CPU with {way} teacher: "
                  f"loss {float(l_card):.6f} (CPU {float(l):.6f}); max "
                  f"|logit diff| {dl:.3g} of max|logit| "
                  f"{float(lg_card.detach().abs().max()):.6g}; worst "
                  f"|diff| / M {ws[0]:.3g} ({ws[1]}), {len(past)} leaves "
                  f"past {cs.TRAIN_C_S} x M {past[:6]}; worst weight "
                  f"gradient rel L2 {ww[0]:.3g} ({ww[1]}); flips code "
                  f"{t.code_flips} tie {t.tie_flips} ReLU {t.relu_flips}",
                  flush=True)
        return res, g

    def after_update(p, st, ost, grads, opt, qcfg, t_log, i):
        """The update of FQ step ``i`` on each device from its own
        gradients (``grads``), the same params and momentum: the log-scales'
        largest move, the non-finite leaves and the loss at the updated
        params."""
        for d, v in devs.items():
            pd, od = ii.to_device((p, ost), v)
            new_p, _ = opt.update(pd, tree.unflatten(pd, [
                grads[d][k].to(v) for k, _ in tree.named_leaves(pd)]), od, i)
            moves = {k: float((a - b).abs().max()) for (k, a), (_, b) in
                     zip(tree.named_leaves(new_p), tree.named_leaves(pd))
                     if ".s_" in k}
            name, move = max(moves.items(), key=lambda kv: kv[1])
            layer, leaf = name.split(".")
            bad = [k for k, t in tree.named_leaves(new_p)
                   if not bool(torch.isfinite(t).all())]
            with torch.no_grad():
                loss, _ = loss_fn(d, qcfg, ii.to_device(st, v),
                                  t_log["card"].to(v))(new_p)
            print(f"{tag}: FQ step {i} update on the {d} (its own "
                  f"gradients): largest log-scale move {move:.6g} ({name}, "
                  f"now {float(new_p[layer][leaf]):.6g}; gradient "
                  f"{float(grads[d][name]):.6g}); non-finite leaves "
                  f"{len(bad)} {bad[:4]}; loss at the updated params "
                  f"{float(loss):.6g}", flush=True)

    saved = [save is None]

    def train_stage(bundle, qcfg, teacher, idx):
        _, label, _ = stages[idx]
        p, st, prev = bundle
        if cs.sw_seeded(path, "q") and prev.is_fp and not qcfg.is_fp:
            p = cs.seed_weight_scales(p, quantized)
        if qcfg.fq and not prev.fq:
            p = calibrate_probe(p, st, qcfg)
        t_log = None
        if teacher is not None:
            t_log = teacher_logits(teacher)
        sched = schedules.cosine(lr, cs.TRAIN_STEPS)
        opt = sgd.make(sched, weight_decay=5e-4)
        ost = opt.init(p)
        for i in range(cs.TRAIN_STEPS):
            if qcfg.fq:
                ((loss, (_, new)), g), g_cpu = fq_step(p, st, qcfg, t_log,
                                                       i)
                if not saved[0]:
                    np.savez(os.path.join(save, f"{path}_fq_step0.npz"),
                             x=x_np, y=y_np,
                             teacher_card=t_log["card"].cpu().numpy(),
                             **{f"p/{k}": v.cpu().numpy()
                                for k, v in tree.named_leaves(p)},
                             **{f"st/{k}": v.cpu().numpy()
                                for k, v in tree.named_leaves(st)},
                             **{f"g/{k}": v.cpu().numpy()
                                for k, v in g.items()
                                if ".s_" in k or k.startswith("head")})
                    saved[0] = True
                after_update(p, st, ost, {"card": g, "cpu": g_cpu}, opt,
                             qcfg, t_log, i)
            else:
                fn = loss_fn("card", qcfg, st,
                             None if t_log is None else t_log["card"])
                (loss, (_, new)), g = taps.value_and_grad(fn, p,
                                                          taps.Taps())
            g_tree = tree.unflatten(p, [g[k] for k, _ in
                                        tree.named_leaves(p)])
            p, ost = opt.update(p, g_tree, ost, i)
            st = new
            print(f"{tag}: {label} step {i}: loss {float(loss):.6f}",
                  flush=True)
        x, y = data["card"]
        with torch.no_grad():
            logits, _ = model.apply(p, st, x, qcfg, cfg)
        acc = float((logits.argmax(-1) == y).float().mean())
        print(f"{tag}: {label}: accuracy on the batch {acc}", flush=True)
        return (p, st, qcfg), acc

    p, st = model.init(torch.Generator().manual_seed(cs.SEED), cfg,
                       device=dev)
    gradual.run_ladder([q for q, _, _ in stages], (p, st, QuantConfig()),
                       train_stage)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, nargs="+", default=[0.05])
    ap.add_argument("--ways", nargs="+", default=list(WAYS), choices=WAYS,
                    help="the CPU's teacher logits at each FQ step")
    ap.add_argument("--ladder", default="smoke", choices=("smoke", "table"),
                    help="chip_smoke's stages, or the paper's ladder up to "
                    "its first FQ stage")
    ap.add_argument("--save", default=None,
                    help="directory for the first FQ step's inputs (.npz)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        cs.fail("this probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"nvidia-smi: {cs.nvidia_smi()}", flush=True)
    if args.save:
        os.makedirs(args.save, exist_ok=True)
    for k, lr in enumerate(args.lr):
        run(torch, dev, "resnet32", lr, args.save if k == 0 else None,
            ways=args.ways, ladder=args.ladder)
    return 0


if __name__ == "__main__":
    sys.exit(main())
