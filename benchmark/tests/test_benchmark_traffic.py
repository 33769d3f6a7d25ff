"""The traffic mixes, drawn by one generator whose node and relation
rules are found by name (``benchmark/rules/<rule>.py``)."""

import json

import numpy as np
import pytest

from benchmark import generate, harness

SEED = 2**34 + 77
MIXES = sorted(p.stem for p in (harness.BENCH_DIR / "traffic").glob("*.json"))


def _tiny(traffic, **kw):
    return dict(traffic, num_nodes=500, num_edges=4000, num_rel=6, **kw)


@pytest.mark.parametrize("name", MIXES)
def test_every_mix_draws_by_its_rules(name):
    traffic = json.loads(
        (harness.BENCH_DIR / "traffic" / f"{name}.json").read_text())
    assert traffic["name"] == name and traffic["synthetic"] is True
    src, dst, et, n, r = generate.make_graph(_tiny(traffic), SEED)
    doubled = 2 if traffic["inverse"] else 1
    assert src.shape == dst.shape == et.shape == (4000 * doubled,)
    assert n == 500 and r == 6 * doubled
    assert 0 <= min(src.min(), dst.min()) and max(src.max(), dst.max()) < n
    assert 0 <= et.min() and et.max() < r
    again = generate.make_graph(_tiny(traffic), SEED)
    assert all(np.array_equal(a, b) for a, b in zip((src, dst, et), again))
    other = generate.make_graph(_tiny(traffic), SEED + 1)
    assert not np.array_equal(dst, other[1])


def test_relations_are_uniform_where_the_mix_names_no_rule():
    traffic = {"num_nodes": 50, "num_edges": 300, "num_rel": 4,
               "src": {"rule": "uniform"}, "dst": {"rule": "zipf"}}
    a = generate.make_graph(traffic, SEED)
    b = generate.make_graph(dict(traffic, rel={"rule": "uniform"}), SEED)
    assert all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3]))


def test_the_inverse_of_each_edge_has_its_own_relation():
    traffic = {"num_nodes": 50, "num_edges": 300, "num_rel": 4,
               "src": {"rule": "uniform"}, "dst": {"rule": "uniform"},
               "inverse": True}
    src, dst, et, _, r = generate.make_graph(traffic, SEED)
    assert r == 8
    assert np.array_equal(src[300:], dst[:300])
    assert np.array_equal(dst[300:], src[:300])
    assert np.array_equal(et[300:], et[:300] + 4)


def test_an_unknown_rule_is_refused():
    traffic = {"num_nodes": 4, "num_edges": 4, "num_rel": 1,
               "src": {"rule": "no-such-rule"}, "dst": {"rule": "uniform"}}
    with pytest.raises(ValueError, match="no-such-rule"):
        generate.make_graph(traffic, SEED)
