"""The propagate kernels' share of their roofline, in %: each layer's
forward and whole backward at their least time (the larger of the
algorithm's FLOPs over the row type's peak and its bytes over the memory
rate; ``counting.propagate_work``, which counts the relation reduction as
one product whatever computes it) over the kernels' device time a step."""


def read(run):
    least = run.counts.get("propagate_least_s")
    if (least is None or run.groups_s is None
            or run.groups_s["propagate"] <= 0):
        return None
    return 100.0 * least / run.groups_s["propagate"]
