"""The benchmark's own tests (``python -m pytest benchmark/tests``).

They run on the CPU at tiny sizes, where the program runs its kernels'
plain versions; tests marked ``gpu`` need a card and skip without one,
deciding inside the test. Nothing here imports JAX.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def tiny_cell(workload: str, **model):
    """The cell ``workload`` at a tiny size: its configuration with 24-wide
    embeddings and 2 heads of 8, batches of 16 with 4 negatives, on 300
    nodes and 3,000 base edges over 5 relations of its traffic's rule."""
    from benchmark import harness

    cell = harness.load_cell(workload)
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["model"].update(in_dim=24, gat_out_dim=8, gat_heads=2,
                                **model)
    cell.config["train"].update(train_batch_size=16, num_neg=4)
    cell.traffic = dict(cell.traffic, num_nodes=300, num_edges=3000,
                        num_rel=5)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell


# ---------------------------------------------------------------------------
# A stand-in for a card's profile: one step's kineto events, in nanoseconds,
# with the fields the span attribution reads (as the port's own
# tests/test_torch_profiling.py builds its synthetic card trace)
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


# Device nanoseconds of ``card_trace()`` by the span that claims them.
CARD_TRACE_NS = {"relgat/propagate": 360, "relgat/head": 200,
                 "relgat/project": 130, "relgat/optimizer": 45,
                 "relgat/gat_layer": 30, "relgat/score": 20,
                 "unattributed": 10, "relgat/backward": 5}


def card_trace():
    """A profile object whose ``profiler.kineto_results.events()`` hold one
    train step: a GAT layer (a draw and the ELU in the layer's own span, a
    product under ``relgat/project``, the forward kernel under
    ``relgat/propagate``), the head's product, the scorer, the backward
    (the engine's seed, and three kernels on autograd's thread that belong
    to their nodes' forward spans), Adam with a set that has no runtime
    call, and a fill outside every span."""
    launch = "cudaLaunchKernel"
    evaluate = "autograd::engine::evaluate_function: "
    host = [
        _Evt("relgat/step", 0, 3000, corr=1),
        _Evt("relgat/forward", 10, 1200, corr=2),
        _Evt("relgat/gat_layer", 20, 700, corr=3),
        _Evt("aten::bernoulli_", 25, 45, corr=4),
        _Evt(launch, 30, 35, corr=200, link=4),
        _Evt("relgat/project", 100, 250, corr=5),
        _Evt("aten::mm", 110, 200, corr=6, seq=10),
        _Evt(launch, 120, 130, corr=201, link=6),
        _Evt("relgat/propagate", 300, 600, corr=7),
        _Evt("relgat::propagate", 310, 590, corr=8, seq=11),
        _Evt(launch, 320, 330, corr=202, link=8),
        _Evt("aten::elu", 610, 650, corr=9),
        _Evt(launch, 615, 620, corr=203, link=9),
        _Evt("relgat/head", 710, 900, corr=10),
        _Evt("aten::mm", 720, 800, corr=11, seq=12),
        _Evt(launch, 730, 740, corr=204, link=11),
        _Evt("relgat/score", 910, 1190, corr=12),
        _Evt("aten::mul", 920, 950, corr=13),
        _Evt(launch, 925, 930, corr=205, link=13),
        _Evt("relgat/backward", 1210, 2200, corr=14),
        _Evt("aten::fill_", 1220, 1240, corr=15),
        _Evt(launch, 1225, 1230, corr=206, link=15),
        _Evt("relgat/optimizer", 2210, 2900, corr=16),
        _Evt("aten::_foreach_add_", 2220, 2260, corr=17),
        _Evt(launch, 2230, 2235, corr=207, link=17),
        _Evt("aten::fill_", 3100, 3120, corr=18),
        _Evt(launch, 3105, 3110, corr=209, link=18),
        # autograd's thread: the nodes of the head's and the layer's
        # products and of the propagate
        _Evt(evaluate + "MmBackward0", 1300, 1500, thread=2, corr=30,
             seq=12, fwd=1),
        _Evt("MmBackward0", 1305, 1495, thread=2, corr=31, seq=12, fwd=1,
             scope=1),
        _Evt("aten::mm", 1310, 1490, thread=2, corr=32),
        _Evt(launch, 1315, 1320, thread=2, corr=210, link=32),
        _Evt(evaluate + "PropagateBackward", 1600, 1900, thread=2, corr=33,
             seq=11, fwd=1),
        _Evt(launch, 1610, 1615, thread=2, corr=211, link=33),
        _Evt(evaluate + "MmBackward0", 1950, 2100, thread=2, corr=34,
             seq=10, fwd=1),
        _Evt(launch, 1960, 1965, thread=2, corr=212, link=34),
    ]
    device = [
        _Evt("bernoulli_kernel", 50, 60, corr=200, link=4, device=True),
        _Evt("sm90_gemm", 140, 220, corr=201, link=6, device=True),
        _Evt("relgat_fwd_kernel", 340, 500, corr=202, link=8, device=True),
        _Evt("elu_kernel", 620, 640, corr=203, link=9, device=True),
        _Evt("sm90_gemm", 745, 845, corr=204, link=11, device=True),
        _Evt("mul_kernel", 950, 970, corr=205, link=13, device=True),
        _Evt("fill_kernel", 1240, 1245, corr=206, link=15, device=True),
        _Evt("sm90_gemm", 1330, 1430, corr=210, link=32, device=True),
        _Evt("relgat_bwd_src_kernel", 1620, 1820, corr=211, link=33,
             device=True),
        _Evt("sm90_gemm", 1970, 2020, corr=212, link=34, device=True),
        _Evt("add_kernel", 2300, 2340, corr=207, link=17, device=True),
        # a set with no runtime call in the trace: its linked operation
        _Evt("Memset (Device)", 2345, 2350, corr=208, link=17, device=True),
        _Evt("fill_kernel", 3130, 3140, corr=209, link=18, device=True),
        # a USER-scope range's copy on the device timeline: not an op
        _Evt("relgat/user", 50, 2350, corr=1, device=True, user=True),
    ]
    events = host + device
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))
