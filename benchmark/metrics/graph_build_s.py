"""Seconds of the program's graph build and layout (``data/graph.py``
``build_graph(..., csr=True)``: the dst sort, both CSR orderings and both
work plans, and the copies to the device), by the host clock around the
benchmark's call, ending in a synchronise."""


def read(run):
    return run.graph_build_s
