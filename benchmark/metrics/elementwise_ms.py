"""Device milliseconds a step in every other device operation: the head's
and loss's elementwise work, the optimizer, dropout, the casts, copies and
reductions, from the traced steps."""


def read(run):
    if run.groups_s is None or run.groups_s["other"] <= 0:
        return None
    return 1e3 * run.groups_s["other"]
