"""Analysis targets: the stacks, traces and shapes the passes run over.

Counterpart of ``repro.analysis.targets``. Self-contained stand-in stacks
built with the port's own recipe (``init`` from a seeded generator ->
``to_fq`` -> a uniform ``s_out`` tied along the chain -> ``convert_int``,
as ``tests/test_torch_planlint.py`` builds them), the declared conv
geometries each stack serves (for kernellint), and :func:`run_analysis`,
the one call the command line and the tests share.

Every target function takes a ``device``; the card is the default. A core traced
on the card runs its kernels there (``kernels.library``), on the CPU their
plain versions; the graphs hold the same nodes.
"""
from __future__ import annotations

import dataclasses
import importlib
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core import integer_inference as ii
from ..core import prng, quant
from ..core.noise import NoiseConfig
from ..core.quant import QuantConfig, n_levels
from ..device import DeviceLike, resolve_device
from ..kernels import fq_conv
from ..models import darknet, fq_lm, kws
from . import intlint, kernellint, planlint
from .intlint import TraceSpec
from .kernellint import ConvShape
from .report import Report, Suppression

DEFAULT_QCFG = QuantConfig(2, 4, 4, fq=True)
DEFAULT_MAC_CHUNKS = (1, 4, 16)
# Table 7's harshest condition: the worst case for interval blow-up.
DEFAULT_NOISE = NoiseConfig(0.30, 0.30, 1.50)
NOISE_SEED = 7
# Declared serving input extents (the shape-ladder rungs the batcher
# folds onto): KWS serves cfg.seq_len MFCC frames; DarkNet serves the
# paper's ImageNet letterbox (reduced stacks serve the benchmark size).
DARKNET_INPUT = 224
DARKNET_REDUCED_INPUT = 28

_STANDIN_CACHE: Dict = {}

# Repo-wide reasoned exemptions (docs/ANALYSIS.md "Suppressions"). Every
# entry must say WHY the finding is acceptable: an empty tuple means the
# checked-in tree is finding-free at the default gate.
DEFAULT_SUPPRESSIONS: Tuple = ()


@dataclasses.dataclass
class StackTarget:
    """Everything the three passes need to know about one stack."""

    name: str
    module: object
    cfg: object
    qcfg: QuantConfig
    fq_params: dict
    stack: object                  # ConvertedStack
    chain: List[str]               # code-carrying layer names, in order
    shapes: List[ConvShape]        # served conv geometries
    plan: Optional[list] = None    # darknet-style plan (fused-pool lint)
    n_pool_markers: int = 0
    core_example: Tuple = ()       # example codes for int_core tracing
    weight_format: str = "int8"    # packed storage the stack was built with
    # residual-add DAG stacks declare scale-tie edges instead of the
    # pairwise chain contract, and pin their own impl list (matmul cores
    # have a single integer impl)
    handoff_edges: Optional[list] = None
    impls: Optional[Tuple[str, ...]] = None
    device: Optional[torch.device] = None


def _resolve_format(qcfg: QuantConfig, weight_format: Optional[str]) -> str:
    if weight_format is None:
        return "int8"
    if weight_format == "auto":
        return quant.auto_weight_format(n_levels(qcfg.bits_w))
    return weight_format


def _standin(module, cfg, names, qcfg, *, device, s_out=0.2, seed=0,
             weight_format="int8"):
    """Init-and-fold integer stand-in with a consistent hand-off chain."""
    key = (module.__name__, cfg, tuple(names), qcfg, float(s_out), int(seed),
           weight_format, str(device))
    hit = _STANDIN_CACHE.get(key)
    if hit is not None:
        return hit
    params, state = module.init(torch.Generator().manual_seed(seed), cfg,
                                device=device)
    params = module.to_fq(params, state, cfg)
    for n in names:
        params[n] = {**params[n], "s_out": torch.tensor(
            s_out, dtype=torch.float32, device=device)}
    params = ii.sync_handoff(params, names)
    out = (params, state, module.convert_int(params, state, qcfg, cfg,
                                             weight_format=weight_format))
    _STANDIN_CACHE[key] = out
    return out


# ---------------------------------------------------------------------------
# declared conv geometries
# ---------------------------------------------------------------------------


def kws_conv_shapes(cfg, batch: int = 1,
                    weight_format: str = "int8") -> List[ConvShape]:
    shapes = []
    t, cin = cfg.seq_len, cfg.embed
    for name, dil in kws.layer_plan(cfg):
        t_out = t - dil * (cfg.ksize - 1)
        shapes.append(ConvShape(
            name=f"kws/{name}", ho=t_out, wo=1, cin=cin, cout=cfg.filters,
            kh=cfg.ksize, kw=1, weight_format=weight_format))
        t, cin = t_out, cfg.filters
    return shapes


def darknet_conv_shapes(cfg, input_hw: int, batch: int = 1,
                        weight_format: str = "int8") -> List[ConvShape]:
    """Geometries of the INTEGER convs (the FP edge convs never reach the
    kernels). SAME padding keeps H through convs; pools floor-halve."""
    convs = [l for l in cfg.layers if l != "M"]
    couts = {f"conv{i}": co for i, (_, co) in enumerate(convs)}
    cins = {}
    cin = cfg.in_channels
    for i, (_, co) in enumerate(convs):
        cins[f"conv{i}"] = cin
        cin = co
    shapes = []
    h = input_hw
    for step in darknet.layer_plan(cfg):
        if step[0] == "fp_conv":
            continue                      # FP edge conv, SAME: h unchanged
        if step[0] == "pool":
            h = h // 2
            continue
        _, name, ks, pooled = step
        shapes.append(ConvShape(
            name=f"darknet/{name}", ho=h, wo=h, cin=cins[name],
            cout=couts[name], kh=ks, kw=ks,
            pool=(2, 2) if pooled else None, weight_format=weight_format))
        if pooled:
            h = h // 2
    return shapes


# ---------------------------------------------------------------------------
# stack targets
# ---------------------------------------------------------------------------


def kws_target(qcfg: QuantConfig = DEFAULT_QCFG, *, reduced: bool = False,
               batch: int = 1, weight_format: Optional[str] = None,
               device: DeviceLike = None) -> StackTarget:
    dev = resolve_device(device)
    fmt = _resolve_format(qcfg, weight_format)
    cfg = kws.KWSConfig.reduced() if reduced else kws.KWSConfig()
    names = kws.conv_names(cfg)
    fq_params, _, stack = _standin(kws, cfg, names, qcfg, device=dev,
                                   weight_format=fmt)
    codes = torch.zeros((batch, cfg.seq_len, cfg.embed), dtype=torch.int8,
                        device=dev)
    name = "kws-reduced" if reduced else "kws"
    if fmt != "int8":
        name = f"{name}-{fmt}"
    return StackTarget(
        name=name, module=kws, cfg=cfg, qcfg=qcfg, fq_params=fq_params,
        stack=stack, chain=names,
        shapes=kws_conv_shapes(cfg, batch, weight_format=fmt),
        core_example=(codes,), weight_format=fmt, device=dev)


def darknet_target(qcfg: QuantConfig = DEFAULT_QCFG, *,
                   reduced: bool = False, batch: int = 1,
                   weight_format: Optional[str] = None,
                   device: DeviceLike = None) -> StackTarget:
    dev = resolve_device(device)
    fmt = _resolve_format(qcfg, weight_format)
    cfg = (darknet.DarkNetConfig.reduced() if reduced
           else darknet.DarkNetConfig())
    input_hw = DARKNET_REDUCED_INPUT if reduced else DARKNET_INPUT
    all_names = [f"conv{i}" for i in
                 range(len([l for l in cfg.layers if l != "M"]))]
    fq_params, _, stack = _standin(darknet, cfg, all_names, qcfg,
                                   device=dev, weight_format=fmt)
    plan = darknet.layer_plan(cfg)
    # core input: codes right after the FP prefix (conv0 + pre-entry pools)
    h = input_hw
    for step in plan[:darknet._split_plan(plan)]:
        if step[0] == "pool":
            h = h // 2
    convs = [l for l in cfg.layers if l != "M"]
    codes = torch.zeros((batch, h, h, convs[0][1]), dtype=torch.int8,
                        device=dev)
    name = "darknet-reduced" if reduced else "darknet"
    if fmt != "int8":
        name = f"{name}-{fmt}"
    return StackTarget(
        name=name, module=darknet, cfg=cfg, qcfg=qcfg, fq_params=fq_params,
        stack=stack, chain=darknet.int_conv_names(cfg),
        shapes=darknet_conv_shapes(cfg, input_hw, batch, weight_format=fmt),
        plan=plan, n_pool_markers=sum(1 for l in cfg.layers if l == "M"),
        core_example=(codes,), weight_format=fmt, device=dev)


def lm_target(qcfg: QuantConfig = DEFAULT_QCFG, *, reduced: bool = False,
              batch: int = 1, seq: int = 4,
              device: DeviceLike = None) -> StackTarget:
    """The integer transformer core over its residual-add DAG.

    The core's example args are the two integer-segment entries: stream
    codes plus per-layer stand-in attention-island output codes (the
    island itself, a float softmax in the reference and the port's
    ``lm_island`` kernel, is outside the traced integer core: see
    ``fq_lm.int_core``). Matmuls have one integer impl, so the target pins
    ``impls=("int8",)``.
    """
    dev = resolve_device(device)
    cfg = fq_lm.FQLMConfig.reduced() if reduced else fq_lm.FQLMConfig()
    key = ("fq_lm", cfg, qcfg, str(dev))
    hit = _STANDIN_CACHE.get(key)
    if hit is None:
        params = fq_lm.standin_params(torch.Generator().manual_seed(0), cfg,
                                      device=dev)
        hit = (params, fq_lm.convert_int(params, cfg, qcfg))
        _STANDIN_CACHE[key] = hit
    fq_params, stack = hit
    codes = torch.zeros((batch, seq, cfg.d_model), dtype=torch.int8,
                        device=dev)
    attn = torch.zeros((cfg.n_layers, batch, seq, cfg.d_model),
                       dtype=torch.int8, device=dev)
    return StackTarget(
        name="lm-reduced" if reduced else "lm",
        module=fq_lm, cfg=cfg, qcfg=qcfg, fq_params=fq_params, stack=stack,
        chain=fq_lm.proj_names(cfg), shapes=[],
        core_example=(codes, attn),
        handoff_edges=fq_lm.handoff_edges(cfg), impls=("int8",), device=dev)


def default_targets(qcfg: QuantConfig = DEFAULT_QCFG, *,
                    reduced: bool = False,
                    device: DeviceLike = None) -> List[StackTarget]:
    """int8 stacks plus their packed (auto: ternary at the default
    2-bit-weight qcfg) twins, traced and linted like the int8 ones, plus
    the integer transformer core over its residual-add DAG."""
    return [kws_target(qcfg, reduced=reduced, device=device),
            darknet_target(qcfg, reduced=reduced, device=device),
            kws_target(qcfg, reduced=reduced, weight_format="auto",
                       device=device),
            darknet_target(qcfg, reduced=reduced, weight_format="auto",
                           device=device),
            lm_target(qcfg, reduced=reduced, device=device)]


# ---------------------------------------------------------------------------
# trace specs
# ---------------------------------------------------------------------------


def core_traces(target: StackTarget, *, impls: Sequence[str] = ("im2col",
                "fused"), mac_chunks: Sequence[int] = DEFAULT_MAC_CHUNKS,
                noise: NoiseConfig = DEFAULT_NOISE) -> List[TraceSpec]:
    """Clean + noisy int_core traces for one stack: every impl, and the
    noise model at every requested mac_chunks. A target that pins its own
    ``impls`` (the matmul LM core) overrides the requested impl list.

    The noisy traces take the noise key as an argument (untainted, bounded
    by its words' concrete range), so its threefry rounds are interpreted
    by the interval rules, not replayed as constants."""
    ip, qcfg, cfg, mod = (target.stack, target.qcfg, target.cfg,
                          target.module)
    ex = tuple(target.core_example)
    key = prng.PRNGKey(NOISE_SEED, device=target.device)
    codes_args = tuple(range(len(ex)))
    # packed cores additionally prove every contraction's weight operand
    # decodes into the declared format's sign-extended range
    wr = (quant.format_interval(target.weight_format)
          if target.weight_format != "int8" else None)
    specs = []
    for impl in (target.impls or impls):
        def clean(*a, impl=impl):
            return mod.int_core(ip, *a, qcfg, cfg, impl=impl)

        specs.append(TraceSpec(f"{target.name}/{impl}/clean", clean, ex,
                               weight_range=wr))
        for k in mac_chunks:
            def noisy(*a, impl=impl, k=k):
                return mod.int_core(ip, *a[:-1], qcfg, cfg, impl=impl,
                                    noise=noise, rng=a[-1], mac_chunks=k)

            specs.append(TraceSpec(
                f"{target.name}/{impl}/noise/mac_chunks={k}", noisy,
                ex + (key,), tainted_args=codes_args, weight_range=wr))
    return specs


# ---------------------------------------------------------------------------
# running the passes
# ---------------------------------------------------------------------------


# a worker process's targets: what the parent shipped, and what it rebuilt
_SHIPPED: Dict[int, dict] = {}
_REBUILT: Dict[int, StackTarget] = {}


def _ship(target: StackTarget) -> dict:
    """What a worker needs to trace a target's cores: its stack on the
    CPU, statics, and the example inputs' shapes."""
    return dict(name=target.name, module=target.module.__name__,
                cfg=target.cfg, qcfg=target.qcfg,
                stack=target.stack.to("cpu"),
                example=[(tuple(a.shape), a.dtype)
                         for a in target.core_example],
                weight_format=target.weight_format, impls=target.impls,
                device=str(target.device))


def _receive(shipped: Dict[int, dict]):
    _SHIPPED.update(shipped)


def _lint_traces(key, index, impls, mac_chunks, suppressions):
    """One trace of a shipped target, in a worker process: its report's
    parts and figures."""
    t = _REBUILT.get(key)
    if t is None:
        p = _SHIPPED[key]
        dev = torch.device(p["device"])
        t = _REBUILT[key] = StackTarget(
            name=p["name"], module=importlib.import_module(p["module"]),
            cfg=p["cfg"], qcfg=p["qcfg"], fq_params={},
            stack=p["stack"].to(dev), chain=[], shapes=[],
            core_example=tuple(torch.zeros(s, dtype=d, device=dev)
                               for s, d in p["example"]),
            weight_format=p["weight_format"], impls=p["impls"], device=dev)
    spec = core_traces(t, impls=impls, mac_chunks=mac_chunks)[index]
    r = Report(suppressions)
    fig = intlint.lint_trace(spec, r)
    return r.findings, r.suppressed, r.proofs, r.counters, fig


def _traces_in_workers(targets, jobs, impls, mac_chunks, suppressions):
    """Every trace of ``targets`` across ``jobs`` spawned processes, each
    handed every target's stack once, the longest traces first (noisy
    before clean, deep before shallow); results in the serial order."""
    tasks = []   # (target index, trace index, subject, layers)
    for k, t in enumerate(targets):
        specs = core_traces(t, impls=impls, mac_chunks=mac_chunks)
        tasks += [(k, i, s.subject, len(t.chain))
                  for i, s in enumerate(specs)]
    order = sorted(range(len(tasks)), key=lambda j: (
        tasks[j][2].endswith("/clean"), -tasks[j][3]))
    ctx = multiprocessing.get_context("spawn")
    shipped = {k: _ship(t) for k, t in enumerate(targets)}
    with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx,
                             initializer=_receive,
                             initargs=(shipped,)) as pool:
        futs = {j: pool.submit(_lint_traces, tasks[j][0], tasks[j][1],
                               tuple(impls), tuple(mac_chunks),
                               tuple(suppressions)) for j in order}
        results = [futs[j].result() for j in range(len(tasks))]
    by_target: Dict[int, list] = {}
    for (k, _, _, _), res in zip(tasks, results):
        by_target.setdefault(k, []).append(res)
    return by_target


def run_analysis(targets: Sequence[StackTarget], *,
                 mac_chunks: Sequence[int] = DEFAULT_MAC_CHUNKS,
                 impls: Sequence[str] = ("im2col", "fused"),
                 suppressions: Optional[Sequence[Suppression]] = None,
                 table_path: Optional[str] = None,
                 skip_intlint: bool = False,
                 figures: Optional[dict] = None, jobs: int = 1) -> Report:
    """All three passes over the given stacks; one merged Report.

    ``table_path`` lints a candidate autotune table file instead of the
    checked-in one (schema + the block picks it would produce).
    ``figures``, a dict, receives each trace's figures by subject
    (:func:`.intlint.lint_trace`). ``jobs`` > 1 runs the traces in that
    many spawned processes, each handed the targets' stacks: tracing costs
    host time a node, and the report is the serial one.
    """
    if suppressions is None:
        suppressions = DEFAULT_SUPPRESSIONS
    report = Report(suppressions)
    shape_kw = {}
    if table_path is not None:
        kernellint.lint_table_schema(report, table_path)
        # load_autotune_table overlays builtins with the candidate file
        shape_kw = {"table": fq_conv.load_autotune_table(table_path),
                    "measured": fq_conv.measured_keys(table_path)}
    else:
        kernellint.lint_table_schema(report)
    parallel = (_traces_in_workers(targets, jobs, impls, mac_chunks,
                                   suppressions)
                if jobs > 1 and not skip_intlint else None)
    for k, t in enumerate(targets):
        if t.handoff_edges is not None:
            planlint.lint_handoff_edges(t.fq_params, t.handoff_edges,
                                        report, t.name)
        else:
            planlint.lint_handoff(t.fq_params, t.chain, report, t.name)
        planlint.lint_stack(t.stack, report, t.name,
                            layer_params=t.fq_params)
        planlint.lint_noise_seeds(t.chain, report, t.name)
        if t.plan is not None:
            planlint.lint_fused_pools(t.plan, t.n_pool_markers, report,
                                      t.name, stack=t.stack)
        kernellint.lint_shapes(t.shapes, report, **shape_kw)
        if skip_intlint:
            continue
        specs = core_traces(t, impls=impls, mac_chunks=mac_chunks)
        if parallel is None:
            figs = [intlint.lint_trace(spec, report) for spec in specs]
        else:
            figs = []
            for findings, suppressed, proofs, counters, fig in \
                    parallel[k]:
                part = Report(suppressions)
                part.findings, part.suppressed = findings, suppressed
                part.proofs, part.counters = proofs, counters
                report.merge(part)
                figs.append(fig)
        for spec, fig in zip(specs, figs):
            if figures is not None and fig is not None:
                figures[spec.subject] = fig
    kernellint.runtime_miss_counters(report)
    return report
