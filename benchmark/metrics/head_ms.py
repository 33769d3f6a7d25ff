"""Device milliseconds a step in the projection head: every device
operation under ``relgat/head`` (its products, the fused GELU → LayerNorm
blocks, dropout and casts), forward and backward, by the benchmark's
frozen span attribution (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.ms_a_step(run, ("relgat/head",))
