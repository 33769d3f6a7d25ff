"""The matrix products' share of their roofline, in %: the sum over a
step's products of each one's least time (the larger of its FLOPs over
the operand type's peak and its bytes over the memory rate;
``counting.gemm_work``) over their device time a step."""


def read(run):
    least = run.counts.get("gemm_least_s")
    if least is None or run.groups_s is None or run.groups_s["gemm"] <= 0:
        return None
    return 100.0 * least / run.groups_s["gemm"]
