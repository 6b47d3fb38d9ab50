"""Launch helpers of the port: counterpart of ``repro.launch`` (only
:func:`.mesh.replica_devices` so far)."""
