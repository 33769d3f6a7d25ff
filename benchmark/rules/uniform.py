"""Node rule ``uniform``: every one of the ``n`` ids equally likely."""


def draw(rng, rule, n, e):
    return rng.integers(0, n, e)
