"""Device milliseconds a step in the propagate's forward pass: every
device operation under ``relgat/propagate`` in the phase ``forward`` (the
forward kernel, its merge, the bf16 rounding of ``h`` and the buffers), by
the benchmark's frozen span attribution (``benchmark/spans.py``). With
``propagate_bwd_ms`` it sums to the span's device time."""

from benchmark import span_phases


def read(run):
    return span_phases.ms_a_step(run, "relgat/propagate", "forward")
