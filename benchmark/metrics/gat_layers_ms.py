"""Device milliseconds a step in the GAT layers: every device operation
under ``relgat/gat_layer`` (its random draws, output dropout and ELU) and
its child spans ``relgat/project`` (the layer's projection) and
``relgat/propagate`` (the propagate call), forward and backward, by the
benchmark's frozen span attribution (``benchmark/spans.py``)."""

from benchmark import spans

SPANS = ("relgat/gat_layer", "relgat/project", "relgat/propagate")


def read(run):
    return spans.ms_a_step(run, SPANS)
