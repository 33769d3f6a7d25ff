"""Device milliseconds a step in the propagate's backward pass: every
device operation that autograd's thread runs for ``relgat/propagate``'s
node, the phase ``backward`` (the src pass, its merge, the relation
reduction and its sum, the casts and buffers), by the benchmark's frozen
span attribution (``benchmark/spans.py``). With ``propagate_fwd_ms`` it
sums to the span's device time."""

from benchmark import span_phases


def read(run):
    return span_phases.ms_a_step(run, "relgat/propagate", "backward")
