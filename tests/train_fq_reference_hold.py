#!/usr/bin/env python3
"""The JAX reference's ResNet-32 FQ training step on the inputs that
``tools/train_fq_probe.py --save`` wrote on the card, against the card's.

The probe saves, at a row's first FQ step, the card's params, batch,
teacher logits and gradients of the log-scales and the head. This script
runs the reference (``repro.models.resnet``, ``repro.core.distill``,
``repro.optim``) on the CPU on those numbers: the step's loss and
gradients, the SGD update at ``--lr`` (the row's cosine schedule, weight
decay 5e-4, Nesterov 0.9) and the loss at the updated params. An FQ net has
no batch statistics, so the batch is run one image at a time (a full-width
net at B=1) and the gradients summed: the loss and the weights' gradients
are means over the batch, and an activation log-scale's gradient is
scaled by the LSQ factor 1 / sqrt(elements x levels) of the whole batch,
sqrt(B) below the single image's. Prints the reference's loss against the card's, each
log-scale's gradient against the card's (|diff| / |card|) and the update's
largest log-scale move and non-finite leaves. The sums of one image at a
time run their convs in another order than the card's batch, so exact
ties at clip bounds fall apart and move a log-scale's gradient by whole
terms: ``--per-image`` holds the port on the CPU against the reference
image by image instead, as the CPU tests hold them
(``tests/test_torch_fq_layers.hold_against_reference``: code, tie and ReLU
flips counted and pinned, then values and every gradient within the
tests' tolerances); for an image outside them it also compares the
gradients by the logits and, from the reference's, the port's below the
head.

CPU only, needs jax and the reference package (as the tests do)::

    PYTHONPATH=src python tests/train_fq_reference_hold.py \\
        chiprun_out/probe3/resnet32_fq_step0.npz --lr 0.05
"""
from __future__ import annotations

import argparse
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

STEPS = 3          # chip_smoke.TRAIN_STEPS: the cosine schedule's length
ALPHA = 0.7        # chip_smoke.TRAIN_ALPHA


def nested(flat, prefix):
    """{"a.b": v} under ``prefix/`` -> {"a": {"b": v}}."""
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix + "/"):
            layer, leaf = k[len(prefix) + 1:].split(".")
            out.setdefault(layer, {})[leaf] = v
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("npz")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--per-image", action="store_true",
                    help="hold the port against the reference image by "
                    "image with the CPU tests' taps and tolerances")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.core import distill
    from repro.core.quant import QuantConfig
    from repro.models import resnet
    from repro.optim import schedules, sgd

    d = np.load(args.npz)
    flat = {k: d[k] for k in d.files}
    params = jax.tree_util.tree_map(jnp.asarray, nested(flat, "p"))
    state = jax.tree_util.tree_map(jnp.asarray, nested(flat, "st"))
    card = {k[2:]: v for k, v in flat.items() if k.startswith("g/")}
    x, y, t_logits = flat["x"], flat["y"], flat["teacher_card"]
    cfg = resnet.ResNetConfig.resnet32()
    qcfg = QuantConfig(2, 5, 5, fq=True)   # Table 6's FQ stage
    b = x.shape[0]

    def loss_fn(p, xi, yi, ti):
        logits, _ = resnet.apply(p, state, xi, qcfg, cfg, train=True)
        return distill.distillation_loss(logits, ti, yi, alpha=ALPHA)

    if args.per_image:
        return per_image(flat, cfg, qcfg)

    vg = jax.jit(jax.value_and_grad(loss_fn))
    fwd = jax.jit(loss_fn)

    def batch_value_and_grad(p):
        loss, grads = 0.0, None
        for i in range(b):
            li, gi = vg(p, x[i:i + 1], y[i:i + 1], t_logits[i:i + 1])
            loss += float(li) / b
            grads = gi if grads is None else jax.tree_util.tree_map(
                jnp.add, grads, gi)
        # means over the batch; an activation log-scale's LSQ factor
        # sqrt(B) smaller
        grads = {n: {k: v / b / (math.sqrt(b) if k in ("s_in", "s_out")
                                 else 1)
                     for k, v in leaf.items()} for n, leaf in grads.items()}
        return loss, grads

    loss, grads = batch_value_and_grad(params)
    print(f"reference: loss {loss:.6f} on B={b} ({cfg.widths}, "
          f"{qcfg.label()})", flush=True)
    rows = []
    for name, g_card in card.items():
        layer, leaf = name.split(".")
        g_ref = np.asarray(grads[layer][leaf])
        err = float(np.linalg.norm(g_ref - g_card))
        rows.append((err / max(float(np.linalg.norm(g_card)), 1e-30), name,
                     float(np.linalg.norm(g_ref)),
                     float(np.linalg.norm(g_card))))
    rows.sort(reverse=True)
    print("reference against the card, |diff| / |card| of each log-scale "
          "and head gradient, worst first:", flush=True)
    for rel, name, r, c in rows[:12]:
        print(f"  {name}: {rel:.3g} (reference {r:.6g}, card {c:.6g})",
              flush=True)
    print(f"  median {rows[len(rows) // 2][0]:.3g} over {len(rows)} leaves",
          flush=True)

    opt = sgd.make(schedules.cosine(args.lr, STEPS), weight_decay=5e-4)
    new, _ = opt.update(params, grads, opt.init(params), 0)
    moves = {f"{n}.{k}": float(jnp.max(jnp.abs(new[n][k] - params[n][k])))
             for n in params for k in params[n] if k.startswith("s_")}
    worst = max(moves, key=moves.get)
    layer, leaf = worst.split(".")
    bad = [f"{n}.{k}" for n in new for k in new[n]
           if not bool(jnp.all(jnp.isfinite(new[n][k])))]
    new_loss = sum(float(fwd(new, x[i:i + 1], y[i:i + 1],
                             t_logits[i:i + 1])) for i in range(b)) / b
    print(f"reference update at lr {args.lr}: largest log-scale move "
          f"{moves[worst]:.6g} ({worst}, {float(params[layer][leaf]):.6g} "
          f"-> {float(new[layer][leaf]):.6g}; gradient "
          f"{float(grads[layer][leaf]):.6g}); non-finite leaves {len(bad)} "
          f"{bad[:4]}; loss at the updated params {new_loss:.6g}",
          flush=True)
    return 0


def head_pinned(i, jp, js, tp, ts, x, y, t, cfg, tcfg, qcfg, tq):
    """One image's gradient of the loss by the logits, port against
    reference, and the network's gradients below the head with the port's
    backward started from the reference's (the flips pinned as in
    ``hold_against_reference``): worst relative L2 of a weight's gradient,
    worst |diff| / M of a log-scale's."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.core import distill
    from repro.models import resnet
    from repro_torch import taps
    from repro_torch.core import distill as tdistill
    from repro_torch.models import resnet as tres
    from test_torch_fq_layers import RELU_PIN_ULPS, reference_taps

    lj, _ = resnet.apply(jp, js, jnp.asarray(x), qcfg, cfg, train=True)
    gj = np.asarray(jax.grad(lambda lg: distill.distillation_loss(
        lg, jnp.asarray(t), jnp.asarray(y), alpha=ALPHA))(lj))
    with torch.no_grad():
        lt, _ = tres.apply(tp, ts, torch.from_numpy(x), tq, tcfg, train=True)
    lt.requires_grad_(True)
    gt, = torch.autograd.grad(tdistill.distillation_loss(
        lt, torch.from_numpy(t), torch.from_numpy(y), alpha=ALPHA), lt)
    lj, lt, gt = np.asarray(lj), lt.detach().numpy(), gt.numpy()
    g_head = torch.from_numpy(gj.copy())
    relus = []
    with reference_taps(relus=relus) as calls:
        _, jg = jax.value_and_grad(lambda pp: jnp.sum(resnet.apply(
            pp, js, jnp.asarray(x), qcfg, cfg, train=True)[0] * gj))(jp)
    pinned = taps.Taps(taps.recorded(calls=[np.array(a) for a in calls],
                                     relus=relus), relu_ulps=RELU_PIN_ULPS)
    _, tg = taps.value_and_grad(lambda pp: (torch.sum(tres.apply(
        pp, ts, torch.from_numpy(x), tq, tcfg, train=True)[0] * g_head),
        None), tp, pinned)
    worst_w, worst_s = (0.0, ""), (0.0, "")
    for path, a in jax.tree_util.tree_leaves_with_path(jg):
        name = ".".join(str(k.key) for k in path)
        a, b = np.asarray(a), tg[name].numpy()
        if name.rsplit(".", 1)[-1].startswith("s_"):
            m = pinned.mag.get(name, 0.0)
            worst_s = max(worst_s, (float(abs(b - a)) / m if m else 0.0,
                                    name))
        else:
            worst_w = max(worst_w, (float(np.linalg.norm(b - a)) / max(
                float(np.linalg.norm(a)), 1e-30), name))
    print(f"image {i}: max|logit| {float(np.abs(lj).max()):.6g}, port "
          f"against reference {float(np.abs(lt - lj).max()):.3g}; their "
          f"gradients by the logits rel L2 "
          f"{float(np.linalg.norm(gt - gj) / np.linalg.norm(gj)):.3g}; from "
          f"the reference's, the port's below the head: worst weight rel "
          f"L2 {worst_w[0]:.3g} ({worst_w[1]}), worst log-scale |diff| / M "
          f"{worst_s[0]:.3g} ({worst_s[1]})", flush=True)


def per_image(flat, cfg, qcfg):
    """``hold_against_reference`` of the port's FQ step on each image."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import jax.numpy as jnp
    import torch
    from repro.core import distill
    from repro.models import resnet
    from repro_torch import interop
    from repro_torch.core import distill as tdistill
    from repro_torch.models import resnet as tres
    from test_torch_fq_layers import hold_against_reference, port_qcfg

    p, st = nested(flat, "p"), nested(flat, "st")
    jp = {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in p.items()}
    js = {n: {k: jnp.asarray(v) for k, v in d.items()}
          for n, d in st.items()}
    tp, ts = interop.params_from_numpy(p, st, device="cpu")
    tcfg = tres.ResNetConfig.resnet32()
    tq = port_qcfg(qcfg)
    failed = 0
    for i in range(flat["x"].shape[0]):
        x = flat["x"][i:i + 1]
        y = flat["y"][i:i + 1]
        t = flat["teacher_card"][i:i + 1]

        def ref(pp):
            logits, new = resnet.apply(pp, js, jnp.asarray(x), qcfg, cfg,
                                       train=True)
            return distill.distillation_loss(
                logits, jnp.asarray(t), jnp.asarray(y), alpha=ALPHA), \
                (logits, new)

        def port(pp):
            logits, new = tres.apply(pp, ts, torch.from_numpy(x), tq, tcfg,
                                     train=True)
            return tdistill.distillation_loss(
                logits, torch.from_numpy(t), torch.from_numpy(y),
                alpha=ALPHA), (logits, new)
        try:
            report = hold_against_reference(ref, port, jp, tp,
                                            label=f"image {i}")
            print(f"image {i}: held; worst {report['worst'][:2]}",
                  flush=True)
        except AssertionError as e:
            failed += 1
            print(f"image {i}: FAILED {str(e)[:300]}", flush=True)
            head_pinned(i, jp, js, tp, ts, x, y, t, cfg, tcfg, qcfg, tq)
    print(f"per image: {failed} of {flat['x'].shape[0]} images outside the "
          "CPU tests' tolerances", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
