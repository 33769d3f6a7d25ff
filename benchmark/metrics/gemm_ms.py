"""Device milliseconds a step in the matrix products (kernels named
gemm, cutlass, sm90_ or nvjet), from the traced steps."""


def read(run):
    if run.groups_s is None or run.groups_s["gemm"] <= 0:
        return None
    return 1e3 * run.groups_s["gemm"]
