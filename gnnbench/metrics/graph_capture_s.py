"""Seconds the compiled steps (``core/compiled_step.py``) spent warming up
and capturing their CUDA graphs over the run: the sum of
``CompiledStep.stats()`` (the slowest rank)."""
COMBINE = "max"


def read(run):
    return run.captures_s if run.captures_s else None
