"""The port's profiling hooks: ``trace``, the train step's spans and the
readers that split a profile by them.

``trace(None)`` records nothing and yields None; ``trace(dir)`` records
``torch.profiler`` over the block and writes a Chrome trace into ``dir``
(here on the CPU). With no profiler open ``span`` is one shared no-op and a
train step enters no range; under the profiler one step records the span
tree of ``utils/profiling.py`` and ends in the same bits as an untraced
step. On a CPU profile every operation of the forward and the backward
maps to a module span (the backward's through its autograd node's forward
operation); a synthetic trace with device operations, a backward thread
and idle gaps checks ``device_ops``, ``device_time_by_span`` and
``idle_by_span`` where no card is at hand (``tests/test_torch_gpu.py``
checks them on a card).
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from relgat_projector_tpu_torch.config import ModelConfig, TrainConfig
from relgat_projector_tpu_torch.data.graph import (
    build_graph,
    pad_node_embeddings,
)
from relgat_projector_tpu_torch.models.model import init_model
from relgat_projector_tpu_torch.schedules import make_lr_schedule
from relgat_projector_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_optimizer,
)
from relgat_projector_tpu_torch.train.step import make_train_step
from relgat_projector_tpu_torch.utils import profiling
from relgat_projector_tpu_torch.utils.rng import RngStreams
from relgat_projector_tpu_torch.utils.tree import tree_leaves, tree_map

N, E, R, D, B, K = 100, 500, 4, 16, 32, 5
CONFIGS = {
    # two layers and a two-layer head, fp32 through the kernels' plain route
    "fp32": dict(gat_num_layers=2, projection_layers=2),
    # the bf16 mode: one layer, a one-layer head
    "bf16": dict(gat_num_layers=1, projection_layers=1,
                 compute_dtype="bfloat16", kernel_precision="default"),
    # no head: the scorer reads the GAT output
    "no_head": dict(gat_num_layers=2, project_to_input_size=False),
}
MODULES = {"relgat/gat_layer", "relgat/project", "relgat/propagate",
           "relgat/head", "relgat/score"}


def _setup(name):
    rng = np.random.default_rng(7)
    src, dst, et = (rng.integers(0, N, E), rng.integers(0, N, E),
                    rng.integers(0, R, E))
    graph = build_graph(src, dst, et, N, num_rel=R, csr=True, device="cpu")
    emb = torch.from_numpy(pad_node_embeddings(
        rng.standard_normal((N, D)).astype(np.float32), graph.num_nodes))
    model = dict(in_dim=D, num_rel=R, gat_out_dim=8, gat_heads=2,
                 dropout=0.2, projection_dropout=0.2, use_pallas=True,
                 project_to_input_size=True)
    cfg = ModelConfig(**{**model, **CONFIGS[name]})
    tc = TrainConfig(train_batch_size=B, num_neg=K, lr=1e-3,
                     lr_scheduler="linear", warmup_steps=1,
                     eval_ks_ranks=(1, 2), use_self_adv_neg=True)
    sched = make_lr_schedule(tc.lr, "linear", 10, 1)
    opt = make_optimizer(tc, sched)
    state = create_train_state(init_model(cfg, seed=0, device="cpu"), opt,
                               seed=1)
    batch = [torch.from_numpy(rng.integers(0, k, B)) for k in (N, R, N)]
    step = make_train_step(cfg, tc, opt, sched)
    return cfg, step, state, emb, graph, batch + [torch.ones(B)]


def _profiled(step, state, emb, graph, batch):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, emb, graph, *batch)
    return prof, state


def _copy(state):
    clone = lambda t: t.clone()  # noqa: E731
    opt = state.opt_state
    return TrainState(
        params=tree_map(clone, state.params),
        opt_state=type(opt)(mu=tree_map(clone, opt.mu),
                            nu=tree_map(clone, opt.nu),
                            count=opt.count.clone()),
        step=state.step.clone(),
        rng=RngStreams.from_state(state.rng.get_state(), "cpu"),
        nonfinite_steps=state.nonfinite_steps.clone(),
    )


def _span_tree(prof):
    """``(name, children)`` of the outermost spans, nested by time."""
    spans = sorted((e for e in profiling._events(prof)
                    if e.name.startswith(profiling.PREFIX)),
                   key=lambda e: (e.start, -e.end))
    roots, stack = [], []
    for e in spans:
        while stack and stack[-1][0].end < e.end:
            stack.pop()
        node = (e, [])
        (stack[-1][1] if stack else roots).append(node)
        stack.append(node)

    def named(node):
        return (node[0].name, [named(c) for c in node[1]])
    return [named(r) for r in roots]


def _expected_tree(cfg):
    layer = ("relgat/gat_layer", [("relgat/project", []),
                                  ("relgat/propagate", [])])
    forward = [layer] * cfg.gat_num_layers
    if cfg.project_to_input_size:
        forward.append(("relgat/head", []))
    forward.append(("relgat/score", []))
    return [("relgat/step", [("relgat/forward", forward),
                             ("relgat/backward", []),
                             ("relgat/optimizer", []),
                             ("relgat/score", [])])]


def test_trace_none_is_a_no_op():
    with profiling.trace(None) as prof:
        torch.ones(3).sum()
    assert prof is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), worker_name="w") as prof:
        (torch.ones((64, 64)) @ torch.ones((64, 64))).sum()
    assert any("mm" in evt.key for evt in prof.key_averages())
    (path,) = list(tmp_path.glob("w.*.pt.trace.json"))
    assert json.loads(path.read_text())["traceEvents"]


def test_span_opens_a_range_only_under_a_profiler():
    assert profiling.span("relgat/a") is profiling.span("relgat/b")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        inside = profiling.span("relgat/a")
        with inside:
            torch.ones(3).sum()
    assert inside is not profiling.span("relgat/a")
    names = [e.name for e in profiling._events(prof)]
    assert names.count("relgat/a") == 1


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_an_untraced_step_enters_no_range(monkeypatch, name):
    cfg, step, state, emb, graph, batch = _setup(name)
    entered = []

    def counting(real):
        def make(*args, **kw):
            entered.append(args)
            return real(*args, **kw)
        return make

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting(torch._C._profiler._RecordFunctionFast))
    for mod in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function",
                            counting(mod.record_function))
    state, _ = step(state, emb, graph, *batch)
    assert entered == []
    _profiled(step, state, emb, graph, batch)
    assert len(entered) == 7 + 3 * cfg.gat_num_layers


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_profiled_step_records_the_span_tree(name):
    cfg, step, state, emb, graph, batch = _setup(name)
    prof, _ = _profiled(step, state, emb, graph, batch)
    assert _span_tree(prof) == _expected_tree(cfg)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_a_profiled_step_gives_the_bits_of_an_untraced_one(name):
    _, step, state, emb, graph, batch = _setup(name)
    state, _ = step(state, emb, graph, *batch)
    traced, plain = _copy(state), _copy(state)
    _, traced = _profiled(step, traced, emb, graph, batch)
    plain, _ = step(plain, emb, graph, *batch)
    leaves = lambda s: (tree_leaves(s.params)  # noqa: E731
                        + tree_leaves(s.opt_state.mu)
                        + tree_leaves(s.opt_state.nu)
                        + [s.opt_state.count, s.step, s.nonfinite_steps])
    assert int(plain.step) == 2
    for a, b in zip(leaves(traced), leaves(plain)):
        assert torch.equal(a, b)
    for gen in ("host", "device"):
        assert torch.equal(getattr(traced.rng, gen).get_state(),
                           getattr(plain.rng, gen).get_state())


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_every_op_of_a_step_maps_to_a_module_span(name):
    """Forward operations to the span around them; backward ones to the
    span of their node's forward operation (the head's products to the
    head); the engine's own seeding of the backward to ``relgat/backward``;
    Adam to ``relgat/optimizer``."""
    _, step, state, emb, graph, batch = _setup(name)
    prof, _ = _profiled(step, state, emb, graph, batch)
    ops = profiling.host_ops(prof)
    aten = [o for o in ops if o.name.startswith("aten::")]
    forward = {o.span for o in aten if o.phase == "forward"}
    assert forward == MODULES
    backward = {o.span for o in aten if o.phase == "backward"}
    assert backward == MODULES | {"relgat/backward"}
    assert {o.span for o in aten if o.phase == "optimizer"} == {
        "relgat/optimizer"}
    node = "MmBackward0" if name == "fp32" else "_CastMatMulBackward"
    products = {o.span for o in ops if o.name == node}
    assert products == {"relgat/project", "relgat/head"}
    assert not profiling.device_time_by_span(prof)


# ---------------------------------------------------------------------------
# A synthetic trace: what a card's profile holds, in nanoseconds
# ---------------------------------------------------------------------------

class _Kind:
    def __init__(self, name):
        self.name = name


class _Evt:
    def __init__(self, name, start, end, *, thread=1, corr=0, link=0,
                 seq=-1, fwd=0, scope=0, device=False, user=False):
        self._v = dict(name=name, start_ns=start, end_ns=end,
                       start_thread_id=thread, end_thread_id=thread,
                       correlation_id=corr, linked_correlation_id=link,
                       sequence_nr=seq, fwd_thread_id=fwd, scope=scope,
                       is_user_annotation=user, is_async=False,
                       device_type=_Kind("CUDA" if device else "CPU"))

    def __getattr__(self, key):
        return lambda: self._v[key]


def _synthetic_profile():
    host = [
        _Evt("relgat/step", 0, 1000, corr=1),
        _Evt("relgat/forward", 10, 400, corr=2),
        _Evt("relgat/head", 20, 200, corr=3),
        _Evt("aten::mm", 30, 60, corr=4, seq=7),
        _Evt("cudaLaunchKernel", 40, 50, corr=100, link=4),
        _Evt("relgat/score", 210, 390, corr=5),
        _Evt("aten::mul", 220, 240, corr=6, seq=8),
        _Evt("cudaLaunchKernel", 225, 230, corr=101, link=6),
        _Evt("relgat/backward", 410, 800, corr=7),
        _Evt("relgat/optimizer", 810, 990, corr=8),
        _Evt("aten::add_", 820, 840, corr=9),
        _Evt("cudaLaunchKernel", 825, 830, corr=102, link=9),
        # a runtime call outside every operation whose id is an op's
        _Evt("cudaDeviceSynchronize", 950, 960, corr=22),
        _Evt("aten::fill_", 1100, 1120, corr=10),
        _Evt("cudaLaunchKernel", 1105, 1110, corr=103, link=10),
        # autograd's thread: the head's product's node
        _Evt("autograd::engine::evaluate_function: MmBackward0", 500, 600,
             thread=2, corr=20, seq=7, fwd=1),
        _Evt("MmBackward0", 505, 595, thread=2, corr=21, seq=7, fwd=1,
             scope=1),
        _Evt("aten::mm", 510, 590, thread=2, corr=22),
        _Evt("cudaLaunchKernel", 515, 520, thread=2, corr=104, link=22),
    ]
    device = [
        _Evt("sm90_gemm", 70, 150, corr=100, link=4, device=True),
        _Evt("mul_kernel", 240, 260, corr=101, link=6, device=True),
        _Evt("sm90_gemm", 530, 700, corr=104, link=22, device=True),
        _Evt("add_kernel", 850, 870, corr=102, link=9, device=True),
        # a set with no runtime call in the trace: its linked operation
        _Evt("Memset (Device)", 880, 885, corr=105, link=9, device=True),
        _Evt("fill_kernel", 1130, 1140, corr=103, link=10, device=True),
        # a USER-scope range's copy on the device timeline: not an op
        _Evt("relgat/user", 70, 870, corr=1, device=True, user=True),
    ]
    events = host + device
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_device_ops_follow_launches_and_autograd_nodes():
    prof = _synthetic_profile()
    ops = [(o.name, o.span, o.phase) for o in profiling.device_ops(prof)]
    assert ops == [
        ("sm90_gemm", "relgat/head", "forward"),
        ("mul_kernel", "relgat/score", "forward"),
        ("sm90_gemm", "relgat/head", "backward"),
        ("add_kernel", "relgat/optimizer", "optimizer"),
        ("Memset (Device)", "relgat/optimizer", "optimizer"),
        ("fill_kernel", profiling.UNATTRIBUTED, "other"),
    ]
    by_span = profiling.device_time_by_span(prof)
    assert by_span == pytest.approx({
        "relgat/head": 250e-9, "relgat/optimizer": 25e-9,
        "relgat/score": 20e-9, profiling.UNATTRIBUTED: 10e-9}, abs=1e-15)
    assert list(by_span) == ["relgat/head", "relgat/optimizer",
                             "relgat/score", profiling.UNATTRIBUTED]


def test_idle_gaps_go_to_the_stepping_threads_span():
    idle = profiling.idle_by_span(_synthetic_profile())
    assert idle == pytest.approx({
        "relgat/forward": 270e-9, profiling.OUTSIDE_STEP: 245e-9,
        "relgat/backward": 150e-9, "relgat/head": 90e-9,
        "relgat/optimizer": 10e-9}, abs=1e-15)
