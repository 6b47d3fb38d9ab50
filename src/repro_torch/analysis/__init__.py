"""Deployment-artifact lints of the port: counterpart of ``repro.analysis``.

* :mod:`.report`: findings, severities, suppressions and the report;
* :mod:`.planlint`: scale hand-off, rescale representability, fused-pool
  legality, noise-seed uniqueness, statics that survive placement, and the
  fleet registry's invariants (``FleetRuntime.register`` runs it).

The reference's traced-computation passes (``intlint``, ``absint``), its
kernel-table lint (``kernellint``), its targets and its command line are
not ported yet.
"""
from .report import Finding, Report, Severity, Suppression  # noqa: F401
