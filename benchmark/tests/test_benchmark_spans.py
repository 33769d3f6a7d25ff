"""The benchmark's frozen span attribution (``benchmark/spans.py``) against
the port's own (``utils/profiling.py``), and the readers that use it."""

import pytest

from benchmark import harness, spans
from benchmark.tests.conftest import CARD_TRACE_NS, card_trace

READERS = ("gat_layers_ms", "head_ms", "optimizer_ms")


def test_the_frozen_copy_splits_a_card_trace_as_the_port_does():
    from relgat_projector_tpu_torch.utils import profiling

    prof = card_trace()
    assert spans.device_ops(prof) == profiling.device_ops(prof)
    by_span = spans.device_time_by_span(prof)
    assert by_span == profiling.device_time_by_span(prof)
    assert list(by_span) == list(CARD_TRACE_NS)
    assert by_span == pytest.approx(
        {k: ns / 1e9 for k, ns in CARD_TRACE_NS.items()}, abs=1e-15)


def test_an_operation_placed_before_its_launch_keeps_its_span():
    """The device's clock, mapped onto the host's, can put an operation
    before its own launch: the head's forward product (launched at 730 ns)
    and its backward product on autograd's thread (launched at 1315 ns)
    moved to start before their launches still go to ``relgat/head``."""
    prof = card_trace()
    events = prof.profiler.kineto_results.events()
    for evt in events:
        if evt.name() == "sm90_gemm" and evt.correlation_id() in (204, 210):
            evt._v["start_ns"] -= 60
            evt._v["end_ns"] -= 60
    by_span = spans.device_time_by_span(prof)
    assert by_span == pytest.approx(
        {k: ns / 1e9 for k, ns in CARD_TRACE_NS.items()}, abs=1e-15)


@pytest.mark.parametrize("metric, spans_of", [
    ("gat_layers_ms", ("relgat/gat_layer", "relgat/project",
                       "relgat/propagate")),
    ("head_ms", ("relgat/head",)),
    ("optimizer_ms", ("relgat/optimizer",)),
])
def test_a_span_reader_reads_its_spans_a_step(metric, spans_of):
    run = harness.LayerRun(step_s=0.05, graph_build_s=0.4, counts={},
                           trace={"steps": 2, "profile": card_trace()})
    expected = sum(CARD_TRACE_NS[s] for s in spans_of) / 1e6 / 2
    assert harness.metric_reader(metric)(run) == pytest.approx(expected,
                                                               rel=1e-12)


def test_the_readers_split_a_profile_once(monkeypatch):
    """The three readers of one traced record parse its profile once, and
    each still reads its own spans."""
    calls = []
    split = spans.device_time_by_span

    def counted(prof):
        calls.append(prof)
        return split(prof)

    monkeypatch.setattr(spans, "device_time_by_span", counted)
    run = harness.LayerRun(step_s=0.05, graph_build_s=0.4, counts={},
                           trace={"steps": 2, "profile": card_trace()})
    values = [harness.metric_reader(m)(run) for m in READERS]
    assert len(calls) == 1
    assert run.trace["by_span"] == split(card_trace())
    spans_of = (("relgat/gat_layer", "relgat/project", "relgat/propagate"),
                ("relgat/head",), ("relgat/optimizer",))
    assert values == pytest.approx(
        [sum(CARD_TRACE_NS[s] for s in names) / 1e6 / 2
         for names in spans_of], rel=1e-12)


@pytest.mark.parametrize("metric", READERS)
def test_a_span_reader_reads_nothing_without_a_profile(metric):
    read = harness.metric_reader(metric)
    bare = harness.LayerRun(step_s=0.05, graph_build_s=0.4, counts={})
    no_profile = harness.LayerRun(step_s=0.05, graph_build_s=0.4, counts={},
                                  trace={"steps": 4, "profile": None})
    assert read(bare) is None and read(no_profile) is None


@pytest.mark.gpu
def test_the_frozen_copy_on_a_card_trace(card, tiny):
    """A tiny cell's traced steps on the card: the copy gives every
    operation that the port claims the port's span, counts every device
    operation of the trace, and the readers each read."""
    from relgat_projector_tpu_torch.utils import profiling

    cell = tiny("small-bf16.sparse-1m")
    program = harness.make_program(cell, harness.make_inputs(cell, 7, card))
    traced = harness.traced_steps(program, 0, card)
    prof = traced["profile"]
    ours, port = spans.device_ops(prof), profiling.device_ops(prof)
    same = [(o.name, o.start_ns, o.seconds) for o in ours]
    assert same == [(o.name, o.start_ns, o.seconds) for o in port]
    assert all(a.span == b.span for a, b in zip(ours, port)
               if b.span != profiling.UNATTRIBUTED)
    by_span = spans.device_time_by_span(prof)
    total = sum(s for _, s in traced["kernels"])
    assert sum(by_span.values()) == pytest.approx(total, rel=1e-9)
    run = harness.LayerRun(step_s=0.05, graph_build_s=0.4, counts={},
                           trace=traced)
    for metric in READERS:
        assert harness.metric_reader(metric)(run) > 0
