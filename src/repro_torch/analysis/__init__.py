"""Static quantization-contract verifier of the port: counterpart of
``repro.analysis``, every pass of it ported.

Three passes over the serving stacks, one report, one exit code:

* :mod:`.intlint`: traces the integer cores (``int_core``) to torch.fx
  graphs with ``make_fx`` and abstractly interprets them (:mod:`.absint`):
  integer purity (no float promotion of code-derived data outside the
  sanctioned requant/dequant edges) and int32 accumulator safety at
  worst-case contract bounds, for every impl x noise x ``mac_chunks``
  configuration served. The kernels K2, K3 and K3b are one node each in
  those graphs, and their contracts (``kernels.library``) stand in for
  their bodies;
* :mod:`.planlint`: deployment-artifact lints: scale hand-off, rescale
  representability, fused-pool legality, noise-seed uniqueness, statics
  that survive placement, and the fleet registry's invariants
  (``FleetRuntime.register`` runs it);
* :mod:`.kernellint`: autotune-table schema, tile-pick divisibility,
  split-K legality and the block's shared memory for every served conv
  geometry, and the serve-time table misses.

Run ``python -m repro_torch.analysis`` (on the card; ``--device cpu``
traces the cores on the kernels' plain versions); findings gate via the
exit code (any unsuppressed finding at or above ``--fail-on``, default
``warning``). :mod:`.report` holds findings, severities and reasoned
suppressions.
"""
from .report import Finding, Report, Severity, Suppression  # noqa: F401
