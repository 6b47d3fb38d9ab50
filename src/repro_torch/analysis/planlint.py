"""planlint: structural lints over layer plans, ConvertedStacks and the fleet.

Counterpart of ``repro.analysis.planlint``: the same checks, subjects,
severities and messages. It verifies the *deployment artifact and its
recipe*:

* **scale hand-off**: ``s_in[i+1] == s_out[i]`` along the FQ chain (the
  codes handed layer to layer are only meaningful on shared bin edges);
* **rescale representability**: every folded requant scalar is finite,
  positive, float32-representable without flushing to zero or inf, and its
  refold from the source scales matches the stored value;
* **fused-pool legality**: a pool may fuse into a conv epilogue only if the
  requant is monotone (rescale > 0: max then commutes with requant) and the
  pool is non-overlapping; and the plan must consume exactly the "M"
  entries the architecture declares;
* **noise-seed uniqueness**: replay the exact per-layer key split schedule
  (``split(rng, n)``, then ``noisy_operands``' 3-way split and
  ``derive_seed``, all by ``core.prng``, bit-exact with jax's) and require
  pairwise-distinct kernel seeds;
* **static consistency**: the per-layer quantizer statics
  (``n_out``/``lo``/``n_w``/``n_a``) agree with the stack's qcfg and a
  placement round-trip (:func:`~..core.integer_inference.place_stack`, which
  takes the place of the reference's pytree flatten / unflatten) keeps them
  Python values of the same type;
* **the fleet registry** (:func:`lint_fleet`): names, SLOs, canary seeds;
* **the residual-DAG hand-off** (:func:`lint_handoff_edges`): every scale
  tie of a DAG stack's edge list (the integer LM's stream) holds.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core import prng, quant
from ..core.noise import derive_seed
from ..core.quant import n_levels
from .report import Report

_F32_TINY = float(np.finfo(np.float32).tiny)
_F32_MAX = float(np.finfo(np.float32).max)
_HANDOFF_ATOL = 1e-6
_STATICS = ("n_out", "lo", "n_w", "n_a", "weight_format")


def _num(x) -> float:
    """A 0-d tensor (any device), numpy scalar or Python number -> float."""
    if isinstance(x, torch.Tensor):
        return float(x.detach().cpu())
    return float(np.asarray(x))


def lint_handoff(layer_params: Dict[str, dict], names: Sequence[str],
                 report: Report, subject: str):
    """FQ hand-off contract over the source (float-side) scale chain."""
    ok = True
    for a, b in zip(names, names[1:]):
        s_out = _num(layer_params[a]["s_out"])
        s_in = _num(layer_params[b]["s_in"])
        if not math.isclose(s_in, s_out, abs_tol=_HANDOFF_ATOL):
            ok = False
            report.error(
                "planlint/handoff", f"{subject}/{b}",
                f"s_in={s_in:.6f} != previous layer {a}'s "
                f"s_out={s_out:.6f} — codes hand over on mismatched bin "
                "edges (run integer_inference.sync_handoff)",
                prev=a, s_in=s_in, s_out=s_out)
    if ok and len(names) > 1:
        report.prove("planlint/handoff", subject,
                     f"s_in[i+1] == s_out[i] holds across {len(names)} "
                     "layers", layers=len(names))


def lint_handoff_edges(layer_params: Dict[str, dict], edges,
                       report: Report, subject: str):
    """FQ hand-off contract over an explicit scale-tie edge list, the chain
    contract generalized to residual-add DAGs (every branch rejoining the
    stream must requantize onto the stream's scale)."""
    ok = True
    for src, sf, dst, df in edges:
        s_src = _num(layer_params[src][sf])
        s_dst = _num(layer_params[dst][df])
        if not math.isclose(s_dst, s_src, abs_tol=_HANDOFF_ATOL):
            ok = False
            report.error(
                "planlint/handoff", f"{subject}/{dst}",
                f"{dst}.{df}={s_dst:.6f} != {src}.{sf}={s_src:.6f} on a "
                "DAG scale-tie edge — codes hand over on mismatched bin "
                "edges (run integer_inference.sync_handoff_edges)",
                src=src, src_field=sf, dst_field=df,
                s_src=s_src, s_dst=s_dst)
    edges = list(edges)
    if ok and edges:
        report.prove("planlint/handoff", subject,
                     f"scale ties hold across all {len(edges)} DAG "
                     "hand-off edges", edges=len(edges))


def lint_stack(stack, report: Report, subject: str,
               layer_params: Optional[Dict[str, dict]] = None):
    """Structural lints over a ConvertedStack artifact."""
    from ..core.integer_inference import place_stack
    from ..kernels import ops
    qcfg = stack.qcfg
    names = list(stack.layer_names)

    # -- spec/layer agreement ----------------------------------------------
    if set(names) != set(stack.layers):
        report.error("planlint/spec-mismatch", subject,
                     f"spec names {names} != layer keys "
                     f"{sorted(stack.layers)}")
        return
    for i, spec in enumerate(stack.specs):
        is_last = i == len(stack.specs) - 1
        if spec.final and not is_last:
            report.error("planlint/spec-mismatch", f"{subject}/{spec.name}",
                         "final=True on a non-terminal layer — dequant "
                         "mid-chain breaks the code hand-off")

    exp_n_out = n_levels(qcfg.bits_out)
    exp_n_w = n_levels(qcfg.bits_w)
    exp_n_a = n_levels(qcfg.bits_a if qcfg.bits_a is not None
                       else qcfg.bits_out)
    static_ok = True
    rescale_ok = True
    for spec in stack.specs:
        layer = stack.layers[spec.name]
        lsub = f"{subject}/{spec.name}"

        # -- static consistency --------------------------------------------
        expected = {"n_out": exp_n_out, "n_w": exp_n_w, "n_a": exp_n_a,
                    "lo": 0 if spec.relu_out else -exp_n_out}
        for k, want in expected.items():
            got = layer.get(k)
            if got is None:
                static_ok = False
                report.error("planlint/static-aux", lsub,
                             f"missing static quantizer field {k!r}")
            elif not isinstance(got, (int, np.integer)) or \
                    isinstance(got, bool):
                static_ok = False
                report.error(
                    "planlint/static-aux", lsub,
                    f"{k}={got!r} is not a python int — it would trace "
                    "into the kernel's static params", field=k)
            elif int(got) != want:
                static_ok = False
                report.error(
                    "planlint/static-aux", lsub,
                    f"{k}={int(got)} disagrees with qcfg "
                    f"{qcfg.label()} (expected {want})",
                    field=k, got=int(got), want=want)

        # -- weight format + code range ------------------------------------
        # Packed layers store uint8 nibble / bit-plane bytes; the range
        # contract is on the DECODED codes, so unpack first (pad rows
        # decode to 0 and are inert). A tampered packed byte whose field
        # decodes outside +/-n_w (e.g. ternary field 0b10 -> -2) is a
        # code-range finding, not silent garbage.
        fmt = layer.get("weight_format", "int8")
        spec_fmt = getattr(spec, "weight_format", "int8")
        if fmt not in quant.WEIGHT_FORMATS:
            report.error(
                "planlint/weight-format", lsub,
                f"unknown weight_format {fmt!r} (known: "
                f"{quant.WEIGHT_FORMATS}) — the kernel dispatch would "
                "reject this layer", format=fmt)
            continue
        if fmt != spec_fmt:
            report.error(
                "planlint/weight-format", lsub,
                f"layer stores weight_format={fmt!r} but its spec "
                f"declares {spec_fmt!r} — rederive() would re-pack into "
                "a different layout", layer_format=fmt,
                spec_format=spec_fmt)
        codes = quant.unpack_codes(torch.as_tensor(layer["w_codes"]), fmt)
        n_w = int(layer.get("n_w", exp_n_w))
        if codes.numel():
            lo, hi = int(codes.min()), int(codes.max())
            if lo < -n_w or hi > n_w:
                report.error(
                    "planlint/code-range", lsub,
                    f"weight codes [{lo}, {hi}] outside [-{n_w}, {n_w}]",
                    lo=lo, hi=hi, n_w=n_w, format=fmt)

        # -- rescale representability --------------------------------------
        key = "alpha" if "alpha" in layer else "rescale"
        val = _num(layer[key])
        if not math.isfinite(val) or val <= 0.0:
            rescale_ok = False
            report.error("planlint/rescale", lsub,
                         f"{key}={val!r} (expected finite and > 0)",
                         field=key, value=val)
        elif not (_F32_TINY <= val <= _F32_MAX):
            rescale_ok = False
            report.error(
                "planlint/rescale", lsub,
                f"{key}={val:.3e} not float32-representable (flushes to "
                "0/inf in the kernel epilogue)", field=key, value=val)
        elif key == "rescale":
            # requant must be able to reach the top output code: the max
            # accumulator magnitude n_a * n_w * depth times rescale should
            # not round to 0 for every input (a degenerate epilogue).
            depth = int(codes.shape[0])  # unpacked rows, not packed bytes
            acc_max = float(exp_n_a * n_w * depth)
            if acc_max * val < 0.5:
                rescale_ok = False
                report.error(
                    "planlint/rescale", lsub,
                    f"rescale={val:.3e} maps even the maximal accumulator "
                    f"({acc_max:.3g}) below 0.5 — every output rounds to "
                    "the clip floor", value=val, acc_max=acc_max)
        if layer_params is not None and key == "rescale" and \
                spec.name in layer_params:
            p = layer_params[spec.name]
            refold = _num(ops.fold_rescale(
                *(torch.as_tensor(p[k], dtype=torch.float32)
                  for k in ("s_in", "s_w", "s_out")),
                bits_a=qcfg.bits_a, bits_w=qcfg.bits_w,
                bits_out=qcfg.bits_out))
            if math.isfinite(val) and val > 0 and \
                    not math.isclose(refold, val, rel_tol=1e-5):
                rescale_ok = False
                report.error(
                    "planlint/rescale", lsub,
                    f"stored rescale {val:.6e} != refold from source "
                    f"scales {refold:.6e} — stack is stale vs its params",
                    stored=val, refold=refold)

    # -- extras ------------------------------------------------------------
    if "s_out_last" in stack.extras and layer_params is not None and \
            names[-1] in layer_params:
        want = _num(layer_params[names[-1]]["s_out"])
        got = _num(stack.extras["s_out_last"])
        if not math.isclose(got, want, abs_tol=_HANDOFF_ATOL):
            report.error(
                "planlint/handoff", f"{subject}/s_out_last",
                f"decode scale {got:.6f} != last layer's s_out {want:.6f}"
                " — outputs dequantize on the wrong grid",
                got=got, want=want)

    # -- placement round-trip ----------------------------------------------
    rebuilt = place_stack(stack, stack.device)
    for spec in stack.specs:
        a, b = stack.layers[spec.name], rebuilt.layers[spec.name]
        for k in _STATICS:
            if bool(a.get(k) != b.get(k)) or \
                    type(a.get(k)) is not type(b.get(k)):
                static_ok = False
                report.error(
                    "planlint/static-aux", f"{subject}/{spec.name}",
                    f"pytree round-trip changed {k}: "
                    f"{a.get(k)!r} -> {b.get(k)!r}", field=k)

    if static_ok:
        report.prove("planlint/static-aux", subject,
                     "quantizer statics agree with qcfg and survive the "
                     "pytree round-trip", layers=len(names))
    if rescale_ok:
        report.prove("planlint/rescale", subject,
                     "all folded epilogue scalars finite, positive and "
                     "float32-representable", layers=len(names))


def lint_fused_pools(plan, n_pool_markers: int, report: Report, subject: str,
                     stack=None):
    """Fused-pool legality over a darknet-style plan.

    Preconditions for fusing a maxpool into the conv epilogue (operating
    on the pre-requant accumulator): the requant map must be monotone
    non-decreasing (rescale > 0; then max commutes with
    clip(round(acc * rescale))) and the pool non-overlapping (the kernel
    epilogue reduces disjoint 2x2 accumulator tiles). Also checks plan
    bookkeeping: fused + standalone pools must account for exactly the
    architecture's "M" markers.
    """
    fused = [s for s in plan if s[0] == "conv" and s[3]]
    standalone = sum(1 for s in plan if s[0] == "pool")
    if len(fused) + standalone != n_pool_markers:
        report.error(
            "planlint/fused-pool", subject,
            f"plan consumed {len(fused)} fused + {standalone} standalone "
            f"pools but the architecture declares {n_pool_markers} — a "
            "pool was dropped or duplicated",
            fused=len(fused), standalone=standalone,
            declared=n_pool_markers)
        return
    ok = True
    if stack is not None:
        for s in fused:
            name = s[1]
            layer = stack.layers.get(name)
            if layer is None:
                continue
            key = "alpha" if "alpha" in layer else "rescale"
            val = _num(layer[key])
            if not (math.isfinite(val) and val > 0):
                ok = False
                report.error(
                    "planlint/fused-pool", f"{subject}/{name}",
                    f"pool fused into a non-monotone epilogue "
                    f"({key}={val!r} <= 0): max does not commute with "
                    "requant, fused and unfused paths diverge", value=val)
    if ok:
        report.prove(
            "planlint/fused-pool", subject,
            f"{len(fused)} fused + {standalone} standalone pools account "
            f"for all {n_pool_markers} declared pools; fused epilogues "
            "monotone")


def lint_noise_seeds(names: Sequence[str], report: Report, subject: str,
                     base_seeds: Sequence[int] = (0, 1)):
    """Replay the serving key schedule; derived kernel seeds must be
    pairwise distinct per forward pass (a collision makes two layers'
    ADC noise fields identical — correlated noise the paper's model
    excludes)."""
    n = len(names)
    if n < 2:
        return
    collided = False
    for base in base_seeds:
        layer_keys = prng.split(prng.PRNGKey(base), n)
        seeds = []
        for k in layer_keys:
            _, _, k_mac = prng.split(k, 3)
            seeds.append(int(derive_seed(k_mac)))
        dupes = {s for s in seeds if seeds.count(s) > 1}
        if dupes:
            collided = True
            where = [names[i] for i, s in enumerate(seeds) if s in dupes]
            report.error(
                "planlint/seed-collision", subject,
                f"derive_seed collision across layers {where} for base "
                f"seed {base} — their kernel noise fields are identical",
                base_seed=base, layers=where)
    if not collided:
        report.prove(
            "planlint/seed-collision", subject,
            f"per-layer kernel seeds pairwise distinct over {n} layers x "
            f"{len(tuple(base_seeds))} base seeds")


def lint_seed_values(seeds: Sequence[int], names: Sequence[str],
                     report: Report, subject: str):
    """Same uniqueness check for an externally-supplied seed list (the
    mutation tests inject collisions with it)."""
    dupes = {s for s in seeds if list(seeds).count(s) > 1}
    if dupes:
        where = [names[i] for i, s in enumerate(seeds) if s in dupes]
        report.error(
            "planlint/seed-collision", subject,
            f"seed collision across layers {where}", layers=where)


def lint_fleet(models: Sequence, report: Report, subject: str = "fleet",
               *, max_stuck_ticks: int = 0):
    """Registry invariants for the fleet control plane (serve/fleet.py).

    ``models`` is a sequence of ``(name, slo, canary_seed, stack)``
    descriptors (``stack`` may be None for an opaque model). Checks:

    * ``planlint/fleet-name``: model names non-empty and unique (the
      registry, traces and replay all key on them);
    * ``planlint/fleet-slo``: SLO fields in range: ``deadline_ticks``
      must exceed ``1 + max_stuck_ticks`` (a stuck in-flight result may
      legally take that long, so a tighter deadline makes the
      within-SLO guarantee unsatisfiable by construction),
      ``max_agreement_drop`` in (0, 1], window / baseline / retrain budgets
      positive;
    * ``planlint/fleet-seed``: canary seeds pairwise distinct (two
      models sharing a seed draw CORRELATED canary noise: a drift on
      one masks or mimics a drift on the other);
    * each non-None stack passes the full :func:`lint_stack`.

    ``FleetRuntime.register`` runs this over the would-be registry and
    refuses registration on any ERROR finding.
    """
    before = len(report.findings)
    seen: Dict[str, int] = {}
    seeds: Dict[int, str] = {}
    for name, slo, canary_seed, stack in models:
        subj = f"{subject}/{name}"
        if not name or not isinstance(name, str):
            report.error("planlint/fleet-name", subj,
                         f"model name {name!r} is not a non-empty string")
            continue
        if name in seen:
            report.error("planlint/fleet-name", subj,
                         f"duplicate model name {name!r} in the registry")
        seen[name] = 1
        min_deadline = 2 + max_stuck_ticks
        if slo.deadline_ticks < min_deadline:
            report.error(
                "planlint/fleet-slo", subj,
                f"deadline_ticks={slo.deadline_ticks} < {min_deadline} "
                "(dispatch->resolve alone may take "
                f"1 + max_stuck_ticks={max_stuck_ticks} ticks; the "
                "within-SLO guarantee would be unsatisfiable)",
                deadline_ticks=slo.deadline_ticks,
                max_stuck_ticks=max_stuck_ticks)
        if not (0.0 < slo.max_agreement_drop <= 1.0):
            report.error(
                "planlint/fleet-slo", subj,
                f"max_agreement_drop={slo.max_agreement_drop} not in "
                "(0, 1] — breach would fire never or always",
                max_agreement_drop=slo.max_agreement_drop)
        for field, lo in (("canary_window", 1), ("baseline_obs", 1),
                          ("retrain_steps_per_tick", 1), ("canary_every", 0)):
            v = getattr(slo, field, None)
            if v is None or v < lo:
                report.error("planlint/fleet-slo", subj,
                             f"{field}={v!r} must be >= {lo}", field=field,
                             value=v)
        cs = int(canary_seed)
        if cs in seeds:
            report.error(
                "planlint/fleet-seed", subj,
                f"canary_seed={cs} collides with model "
                f"{seeds[cs]!r} — the two canary tiers would draw "
                "correlated noise", canary_seed=cs, other=seeds[cs])
        else:
            seeds[cs] = name
        if stack is not None and hasattr(stack, "qcfg"):
            # opaque (non-ConvertedStack) model objects, toy stacks in
            # unit tests, only get the registry-level checks
            lint_stack(stack, report, subj)
    if len(report.findings) == before:
        report.prove("planlint/fleet", subject,
                     f"registry of {len(tuple(models))} models validated "
                     "(names unique, SLOs satisfiable, canary seeds "
                     "distinct, stacks clean)", models=len(tuple(models)))
