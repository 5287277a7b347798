"""Per-layer metric readers, one module a metric, named after it. Each has
``read(run)`` (a ``harness.report.LayerRun``: one rank's traced window)
returning a number, or None where it finds nothing to read, and
``COMBINE``: how the ranks' readings make one ("max", "mean" or
"rank0")."""
