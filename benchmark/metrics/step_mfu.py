"""The whole train step's share of the card's peak: the step's model
FLOPs (every projection and head product over all node rows, forward,
weight gradient and input gradient, and the propagate's edge work;
``counting.step_counts``) over the untraced step's seconds and the peak
of the projections' operand type, in %. Nothing on a card without known
peaks."""


def read(run):
    peak = run.counts.get("peak_flop_per_s")
    if peak is None or run.step_s <= 0:
        return None
    return 100.0 * run.counts["model_flop"] / run.step_s / peak
