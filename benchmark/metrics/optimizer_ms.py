"""Device milliseconds a step in the optimizer: every device operation
under ``relgat/optimizer`` (Adam, the non-finite select, the new state,
the gradient norm and the learning rate), by the benchmark's frozen span
attribution (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.ms_a_step(run, ("relgat/optimizer",))
