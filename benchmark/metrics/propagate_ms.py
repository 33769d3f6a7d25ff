"""Device milliseconds a step in the propagate kernels (names holding
``relgat``: the forward, the src pass, the relation reduction and their
merges), from the traced steps."""


def read(run):
    if run.groups_s is None or run.groups_s["propagate"] <= 0:
        return None
    return 1e3 * run.groups_s["propagate"]
