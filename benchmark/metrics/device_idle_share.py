"""The share of the untraced step in which no operation ran on the card,
in %: one minus the traced steps' busy seconds a step (the union of the
device's operation intervals) over the untraced step's seconds."""


def read(run):
    if run.busy_s is None or run.step_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.step_s)
