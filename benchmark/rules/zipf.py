"""Node rule ``zipf``: p ~ 1 / rank ** ``exponent`` (default 1), id 0 the
largest hub; a frozen copy of ``chip_smoke.py:zipf_graph``'s rule."""

import numpy as np


def draw(rng, rule, n, e):
    p = 1.0 / np.arange(1, n + 1) ** float(rule.get("exponent", 1.0))
    return rng.choice(n, size=e, p=p / p.sum())
