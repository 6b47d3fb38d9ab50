"""kernellint: autotune-table schema, tile picks, shared memory, split-K.

Counterpart of ``repro.analysis.kernellint``, over the port's table
(``kernels/autotune_table.json``, backend ``cuda``) and tile policy
(``kernels.fq_conv.pick_blocks``). A bad table row should be a lint
finding, not a launch failure or a silent fallback. Four layers of
checking:

* **schema**: the raw JSON is validated directly (format tag, backend
  string, integer knobs, positive values): the loader silently skips
  malformed entries, the linter does not. One port rule: a row that
  names a ``policy`` and no knob is a measured decision to keep the H100
  fallback (the recorder writes ``"fallback"``, or ``"fixed bc = cin_p"``
  for packed keys) and is recorded as info; a row with neither still
  warns, as in the reference;
* **per-shape**: every conv geometry a stack serves goes through
  ``pick_blocks`` and the pick is checked for grid divisibility (bc | cin,
  pool-aligned bho, positive grid) and for the block's dynamic shared
  memory (``kernellint/smem``, the counterpart of the reference's
  ``kernellint/vmem``: ``fq_conv.smem_footprint`` against
  ``fq_conv.SMEM_BUDGET``);
* **split-K** (``kernellint/split-k``): a split as ``fq_conv.launch`` runs
  it: only on unpooled int8 convs, bc | cin, min(split, 8) blocks a
  cluster, and each split's span a multiple of 16 wherever the vector A
  loader is otherwise picked;
* **coverage**: served shape keys without a *measured* entry are counted
  as structured misses (mirroring ``fq_conv.AutotuneMissWarning`` at serve
  time), and the serve-time miss counters are folded in, per replica.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Sequence, Tuple

from ..core import quant
from ..kernels import fq_conv
from .report import Report

_KNOBS = ("bho", "bco", "bc")
MAX_CLUSTER = 8          # csrc/fq_conv.cu: the portable cluster size


@dataclasses.dataclass(frozen=True)
class ConvShape:
    """One conv geometry a stack serves (post-padding output extents)."""

    name: str                      # "kws/conv3"
    ho: int
    wo: int
    cin: int
    cout: int
    kh: int
    kw: int
    stride: Tuple[int, int] = (1, 1)
    pool: Optional[Tuple[int, int]] = None
    weight_format: str = "int8"

    @property
    def key(self) -> Tuple[int, int, int, str]:
        return (self.kh, self.kw, self.stride[0], self.weight_format)


def lint_table_schema(report: Report,
                      path: str = fq_conv.AUTOTUNE_TABLE_PATH):
    """Validate the raw JSON: every row must be loadable on its backend."""
    subject = f"autotune:{path.rsplit('/', 1)[-1]}"
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError:
        report.info("kernellint/table-schema", subject,
                    "no autotune table on disk — builtin defaults only")
        return
    except ValueError as e:
        report.error("kernellint/table-schema", subject,
                     f"unparseable JSON: {e}")
        return
    if not isinstance(doc, dict):
        report.error("kernellint/table-schema", subject,
                     f"top level is {type(doc).__name__}, expected object")
        return
    if doc.get("format") != 1:
        report.error("kernellint/table-schema", subject,
                     f"format={doc.get('format')!r} (expected 1) — the "
                     "loader ignores the whole file")
    if not isinstance(doc.get("backend"), str) or not doc.get("backend"):
        report.error("kernellint/table-schema", subject,
                     f"backend={doc.get('backend')!r} is not a non-empty "
                     "string — entries can never match any backend")
    entries = doc.get("entries", [])
    if not isinstance(entries, list):
        report.error("kernellint/table-schema", subject,
                     f"entries is {type(entries).__name__}, expected list")
        return
    seen = {}
    bad = 0
    for i, e in enumerate(entries):
        esub = f"{subject}[{i}]"
        if not isinstance(e, dict):
            bad += 1
            report.error("kernellint/table-schema", esub,
                         f"entry is {type(e).__name__}, expected object")
            continue
        try:
            key = (int(e["kh"]), int(e["kw"]), int(e["stride"]))
        except (KeyError, TypeError, ValueError):
            bad += 1
            report.error(
                "kernellint/table-schema", esub,
                f"missing/non-integer shape key fields in {e!r} — the "
                "loader silently skips this row", entry=repr(e))
            continue
        if any(k <= 0 for k in key):
            bad += 1
            report.error("kernellint/table-schema", esub,
                         f"non-positive shape key {key}", key=key)
        fmt = e.get("format", "int8")
        if not isinstance(fmt, str) or fmt not in quant.WEIGHT_FORMATS:
            bad += 1
            report.error(
                "kernellint/table-schema", esub,
                f"unknown weight format {fmt!r} for key {key} (known: "
                f"{quant.WEIGHT_FORMATS}) — the loader silently skips "
                "this row", key=key, format=repr(fmt))
            continue
        key = key + (fmt,)
        if fmt != "int8" and e.get("bc") is not None:
            report.warning(
                "kernellint/table-schema", esub,
                f"packed entry {key} carries bc={e['bc']!r} — pick_blocks "
                "fixes packed bc to the padded cin, so this knob is dead",
                key=key, bc=e["bc"])
        knobs = {}
        for k in _KNOBS:
            if k not in e or e[k] is None:
                continue
            if not isinstance(e[k], int) or isinstance(e[k], bool) \
                    or e[k] < 1:
                bad += 1
                report.error(
                    "kernellint/table-schema", esub,
                    f"knob {k}={e[k]!r} is not a positive int — the "
                    "loader silently drops this row", knob=k,
                    value=repr(e[k]))
            else:
                knobs[k] = e[k]
        policy = e.get("policy")
        if not knobs and isinstance(policy, str) and policy.strip():
            report.info("kernellint/table-schema", esub,
                        f"entry {key} keeps policy {policy!r} and no knob — "
                        "a measured decision to keep the H100 fallback",
                        key=key, policy=policy)
        elif not knobs:
            report.warning("kernellint/table-schema", esub,
                           f"entry {key} carries no block knobs — it "
                           "overrides builtins with nothing", key=key)
        if key in seen:
            report.error("kernellint/table-schema", esub,
                         f"duplicate entry for key {key} (first at index "
                         f"{seen[key]}) — last-writer-wins is ambiguous",
                         key=key, first=seen[key])
        else:
            seen[key] = i
    report.count("kernellint/table-entries", len(entries))
    if not bad and entries:
        report.prove("kernellint/table-schema", subject,
                     f"all {len(entries)} rows well-formed "
                     f"(backend={doc.get('backend')!r})")


def lint_split(s: ConvShape, bc: int, report: Report) -> bool:
    """Split-K as ``fq_conv.launch`` runs it for the pick ``bc``: split =
    Cin / bc on unpooled int8 convs only, min(split, 8) blocks a cluster,
    and a span of kh*kw*bc codes a multiple of 16 wherever Cin would take
    the vector A loader. True when the pick is legal."""
    factor = quant.format_factor(s.weight_format)
    cin_eff = -(-s.cin // factor) * factor
    if bc >= cin_eff or bc < 1:
        return True
    if s.pool is not None or s.weight_format != "int8":
        report.error(
            "kernellint/split-k", s.name,
            f"bc={bc} < cin={cin_eff} on a "
            f"{'pooled' if s.pool is not None else s.weight_format} conv — "
            "K3b and packed K3 keep one split, so the pick is not what runs",
            bc=bc, cin=cin_eff, pool=s.pool, weight_format=s.weight_format)
        return False
    if s.cin % bc:
        report.error("kernellint/split-k", s.name,
                     f"split bc={bc} does not divide cin={s.cin} — the "
                     "slices would not cover the reduction", bc=bc,
                     cin=s.cin)
        return False
    split, kspan = s.cin // bc, s.kh * s.kw * bc
    report.count("kernellint/split-k-shapes")
    if s.cin % fq_conv.VECTOR_BYTES == 0 and kspan % fq_conv.VECTOR_BYTES:
        report.warning(
            "kernellint/split-k", s.name,
            f"split {split} spans {kspan} codes, not a multiple of "
            f"{fq_conv.VECTOR_BYTES}: cin={s.cin} would take the vector A "
            "loader, the split falls back to the byte gather", split=split,
            kspan=kspan, cluster=min(split, MAX_CLUSTER))
    return True


def lint_shapes(shapes: Sequence[ConvShape], report: Report, *,
                backend: str = "cuda", table: Optional[dict] = None,
                measured: Optional[set] = None):
    """Push every served geometry through the tile policy and check the
    pick. ``table``/``measured`` default to the live ``fq_conv`` caches
    (pass explicit values to lint a candidate table file)."""
    budget = fq_conv.SMEM_BUDGET
    if table is None:
        table = fq_conv._autotune_table(backend)
        measured = fq_conv._MEASURED.get(backend) or set()
    measured = measured or set()

    clean = True
    missed = {}
    for s in shapes:
        sub = s.name
        packed = s.weight_format != "int8"
        # packed kernels read whole bytes: the effective channel extent is
        # cin padded to the pack factor (pad lanes are inert in the MAC)
        factor = quant.format_factor(s.weight_format)
        cin_eff = -(-s.cin // factor) * factor
        over = table.get(s.key, {})
        # serve-time semantics for the table's bc knob: rounded down to a
        # cin divisor, so a non-divisor row serves fine but the measured
        # winner is not what runs. Packed shapes never take a table bc,
        # pooled ones never split.
        over_bc = over.get("bc") if not packed else None
        if over_bc is not None and s.cin % over_bc != 0:
            eff = fq_conv._divisor_at_most(s.cin, over_bc)
            report.warning(
                "kernellint/table-drift", sub,
                f"table bc={over_bc} for key {s.key} does not divide "
                f"cin={s.cin} — serving rounds down to bc={eff}, so the "
                "measured winner is not what actually runs",
                key=s.key, table_bc=over_bc, effective_bc=eff)
            over_bc = eff
        try:
            bho, bco, bc = fq_conv.pick_blocks(
                ho=s.ho, wo=s.wo, cin=s.cin, cout=s.cout, kh=s.kh,
                kw=s.kw, stride=s.stride, pool=s.pool,
                bho=over.get("bho"), bco=over.get("bco"),
                bc=over_bc if s.pool is None else None,
                weight_format=s.weight_format, backend=backend)
        except ValueError as e:
            clean = False
            report.error("kernellint/blockspec", sub,
                         f"pick_blocks rejected table knobs {over} for "
                         f"{s}: {e}", key=s.key, knobs=over)
            continue

        if bco < 1 or bho < 1 or bc < 1:
            clean = False
            report.error("kernellint/blockspec", sub,
                         f"non-positive block ({bho}, {bco}, {bc})")
            continue
        # grid divisibility invariants the kernel's indexing assumes
        if cin_eff % bc != 0:
            clean = False
            report.error(
                "kernellint/blockspec", sub,
                f"bc={bc} does not divide cin={cin_eff} — weight-row "
                "reads cross a tap boundary", bc=bc, cin=cin_eff)
        if s.pool is not None and bho % s.pool[0] != 0:
            clean = False
            report.error(
                "kernellint/blockspec", sub,
                f"bho={bho} not a multiple of fused pool height "
                f"{s.pool[0]} — pool windows straddle the row tile",
                bho=bho, pool=s.pool)
        n_red = s.kh * s.kw * (cin_eff // bc)
        grid = (math.ceil(s.ho / bho), math.ceil(s.cout / bco), n_red)
        if any(g < 1 for g in grid):
            clean = False
            report.error("kernellint/blockspec", sub,
                         f"degenerate grid {grid}", grid=grid)
        clean = lint_split(s, bc, report) and clean

        smem = fq_conv.smem_footprint()
        report.count("kernellint/shapes-checked")
        if smem > budget:
            clean = False
            report.error(
                "kernellint/smem", sub,
                f"dynamic shared memory {smem} bytes a block for blocks "
                f"({bho}, {bco}, {bc}) exceeds the {budget}-byte budget — "
                "the launch fails before it computes", smem_bytes=smem,
                budget=budget, blocks=(bho, bco, bc))

        if s.key not in measured:
            missed.setdefault(s.key, []).append(s.name)

    for key, names in sorted(missed.items()):
        report.warning(
            "kernellint/autotune-miss", names[0],
            f"served shape key {key} has no measured autotune entry for "
            f"backend {backend!r} ({len(names)} layer(s): "
            f"{', '.join(names)}) — serving falls back to builtin "
            "defaults", key=key, backend=backend, layers=names)
        report.count("kernellint/autotune-misses")

    if clean and shapes:
        report.prove(
            "kernellint/blockspec", f"{len(shapes)} served shapes",
            f"block picks divide their grids, split legally and fit the "
            f"{budget}-byte shared-memory budget", shapes=len(shapes))


def runtime_miss_counters(report: Report):
    """Fold fq_conv's serve-time miss counters into the report.

    Besides the global per-key counts, the serving lanes record misses per
    replica (``AUTOTUNE_MISSES_BY_REPLICA``, tagged via
    ``fq_conv.replica_scope``). Replicas in one process share a backend,
    so they should meet the same shapes against the same table: a lane
    whose miss-key set diverges from the union means the lanes are NOT
    serving identical work (e.g. a per-replica swap half-landed), which is
    worth a warning before it becomes a latency mystery."""
    for key, n in sorted(fq_conv.AUTOTUNE_MISSES.items()):
        report.count(f"kernellint/runtime-miss:{key}", n)
    per: dict = {}
    for (tag, key), n in sorted(fq_conv.AUTOTUNE_MISSES_BY_REPLICA.items(),
                                key=lambda kv: (str(kv[0][0]), kv[0][1])):
        report.count(f"kernellint/runtime-miss:replica[{tag}]:{key}", n)
        per.setdefault(tag, set()).add(key)
    if len(per) > 1:
        union = set().union(*per.values())
        for tag in sorted(per, key=str):
            missing = union - per[tag]
            if missing:
                report.warning(
                    "kernellint/replica-miss-divergence", f"replica[{tag}]",
                    f"replica {tag!r} reported autotune misses for "
                    f"{sorted(per[tag])} but same-backend peers also missed "
                    f"{sorted(missing)} — replica lanes are not tracing "
                    "identical work", replica=tag,
                    missing=sorted(map(str, missing)))
