"""The GAT layer's tail (``ops/cuda/layer_tail.py``): output dropout, ELU and
the next product's rounding.

On the CPU: ``layer_tail`` is the eager chain it replaced (``agg * keep /
(1 - rate)``, then ``F.elu``, then the product's cast) in value and
gradient, with and without the ELU and the mask, and launches nothing; the
model through it equals, bit for bit, the stack written out as it was
before the tail (the ELU between layers outside the layer, every output
fp32); the output-type rule; remat against no remat with bf16 and fp16
compute types; the kernels' gate. No JAX here.

Marked ``gpu`` (each skips without a CUDA device, decided inside the test):
the kernels against the eager chain on the card, bit for bit, forward and
backward. Run them from the repository root, without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_layer_tail.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from relgat_projector_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
    torch_dtype,
)
from relgat_projector_tpu_torch.data.graph import (
    build_graph,
    pad_node_embeddings,
)
from relgat_projector_tpu_torch.device import operand_dtype
from relgat_projector_tpu_torch.models import model as model_mod
from relgat_projector_tpu_torch.models.layer import (
    apply_relgat_layer,
    draw_layer_randomness,
)
from relgat_projector_tpu_torch.models.model import init_model, single_gat_step
from relgat_projector_tpu_torch.models.projection import (
    apply_projection_head,
    head_operand,
    init_projection_head,
)
from relgat_projector_tpu_torch.ops.cuda import layer_tail as lt
from relgat_projector_tpu_torch.schedules import make_lr_schedule
from relgat_projector_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from relgat_projector_tpu_torch.train.step import loss_and_grads
from relgat_projector_tpu_torch.utils.rng import RngStreams
from relgat_projector_tpu_torch.utils.tree import tree_leaves

BF16, FP16, FP32 = torch.bfloat16, torch.float16, torch.float32
N, E, R, D = 60, 300, 4, 16
MODEL = dict(in_dim=D, num_rel=R, gat_out_dim=8, gat_heads=2,
             gat_num_layers=2, dropout=0.3, rel_attn_dropout=0.2,
             project_to_input_size=True, projection_layers=2,
             projection_dropout=0.3)


@pytest.fixture
def one_thread():
    """Bit-identity needs deterministic ops: on the CPU, PyTorch's
    multithreaded accumulating index ops add in a varying order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def eager_chain(agg, keep, rate, elu, out_dtype):
    """The tail as the layer and the model wrote it before
    ``layer_tail``; the cast is the one ``compute_matmul`` made."""
    out = agg
    if keep is not None:
        out = out * keep / (1.0 - rate)
    if elu:
        out = F.elu(out)
    return out.to(out_dtype)


def _rows(n, d, rate, seed, device="cpu"):
    """Random fp32 agg (zeros and exact negatives among them), a keep mask
    drawn as ``draw_layer_randomness`` draws it, and a cotangent."""
    gen = torch.Generator(device=device).manual_seed(seed)
    agg = torch.randn((n, d), generator=gen, device=device) * 2.0
    agg.view(-1)[::97] = 0.0
    agg.view(-1)[1::89] = -0.0
    keep = torch.empty((n, d), device=device).bernoulli_(1.0 - rate,
                                                          generator=gen)
    g = torch.randn((n, d), generator=gen, device=device)
    return agg, keep, g


def _value_and_grad(fn, agg, keep, rate, elu, out_dtype, g):
    a = agg.detach().requires_grad_()
    out = fn(a, keep, rate, elu, out_dtype)
    (da,) = torch.autograd.grad(out, a, g.to(out.dtype))
    return out.detach(), da


def _tail(agg, keep, rate, elu, out_dtype):
    return lt.layer_tail(agg, keep, rate, elu=elu, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_dtype", (FP32, BF16, FP16))
@pytest.mark.parametrize("elu", (True, False))
@pytest.mark.parametrize("rate,masked", ((0.3, True), (0.25, True),
                                         (0.0, False)))
def test_plain_twin_is_the_eager_chain(out_dtype, elu, rate, masked):
    agg, keep, g = _rows(37, 29, rate, seed=3)
    keep = keep if masked else None
    lt.reset_tail_counts()
    got = _value_and_grad(_tail, agg, keep, rate, elu, out_dtype, g)
    want = _value_and_grad(eager_chain, agg, keep, rate, elu, out_dtype, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[0].dtype == out_dtype and got[1].dtype == FP32
    assert lt.tail_counts() == {"layer_tail_fwd": 0, "layer_tail_bwd": 0}


@pytest.mark.parametrize("compute_dtype,follows,want", (
    (BF16, True, BF16), (FP16, True, FP16), (FP32, True, FP32),
    (torch.float8_e4m3fn, True, FP32), (BF16, False, FP32),
    (FP16, False, FP32), (FP32, False, FP32)))
def test_tail_dtype(compute_dtype, follows, want):
    """A product follows: the head has a linear, whose operand type is the
    one every hidden layer's output takes; none: the identity head."""
    linears = [torch.zeros(4, 4)] if follows else []
    assert head_operand({"linears": linears}, compute_dtype) == want
    if follows:
        assert operand_dtype(compute_dtype) == want


def _layer_out_dtypes(monkeypatch, cfg, train, identity_head):
    """The type of every GAT layer's output in a forward of ``cfg``; with
    ``identity_head``, under the head that no layer sets up (no linears,
    equal widths), which ``apply_projection_head`` passes through."""
    seen = []
    apply = model_mod.apply_relgat_layer

    def spy(*args, **kw):
        out = apply(*args, **kw)
        seen.append(out.dtype)
        return out

    monkeypatch.setattr(model_mod, "apply_relgat_layer", spy)
    x, g = _graph(cfg)
    params = init_model(cfg, seed=1, device="cpu")
    if identity_head:
        assert cfg.gat_concat_dim == cfg.in_dim
        params["projection"] = init_projection_head(
            torch.Generator(), cfg.in_dim, cfg.in_dim, 0)
        assert params["projection"]["linears"] == []
    out = single_gat_step(params, cfg, x, g, train=train,
                          rng=RngStreams.from_seed(2, "cpu"))
    assert out.dtype == FP32
    return seen


@pytest.mark.parametrize("name,model,want", (
    ("bf16, a head with linears", dict(compute_dtype="bfloat16"),
     [BF16, BF16]),
    ("fp16", dict(compute_dtype="float16"), [FP16, FP16]),
    ("fp32", dict(compute_dtype="float32"), [FP32, FP32]),
    ("bf16, one layer", dict(compute_dtype="bfloat16", gat_num_layers=1),
     [BF16]),
    ("bf16, the identity head", dict(compute_dtype="bfloat16"),
     [BF16, FP32]),
    ("bf16, no head", dict(compute_dtype="bfloat16",
                           project_to_input_size=False), [BF16, FP32])))
@pytest.mark.parametrize("train", (True, False), ids=("train", "eval"))
def test_layer_outputs_take_the_next_products_type(monkeypatch, name, model,
                                                   want, train):
    """Every layer's output is written in the type of the product that reads
    it next: the next layer's projection or the head's first linear; fp32
    where none does (the identity head, no head) or under fp32; the same in
    training and in evaluation."""
    cfg = ModelConfig(**{**MODEL, **model})
    assert _layer_out_dtypes(monkeypatch, cfg, train,
                             identity_head="identity" in name) == want


def _graph(cfg, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    src, dst, et = (rng.integers(0, N, E), rng.integers(0, N, E),
                    rng.integers(0, R, E))
    g = build_graph(src, dst, et, N, num_rel=R, csr=cfg.use_pallas,
                    device=device)
    emb = rng.standard_normal((N, cfg.in_dim)).astype(np.float32)
    x = torch.from_numpy(pad_node_embeddings(emb, g.num_nodes))
    return x.to(device), g


def written_out_gat_step(params, cfg, node_emb, graph, *, train, rng):
    """``single_gat_step`` as it was written before the tail, in eager ops:
    each layer's output dropout, then the ELU between layers outside the
    layer, every output fp32, and the next product casts its operand."""
    compute_dtype = torch_dtype(cfg.compute_dtype)
    x = node_emb
    for li in range(cfg.gat_num_layers):
        seed, keep = draw_layer_randomness(
            rng, (x.shape[0], cfg.gat_concat_dim), dropout_rate=cfg.dropout,
            attn_dropout_rate=cfg.rel_attn_dropout, train=train,
            device=x.device)
        x = apply_relgat_layer(
            params["layers"][li], x, graph, dropout_rate=cfg.dropout,
            attn_dropout_rate=cfg.rel_attn_dropout, dropout_seed=seed,
            use_pallas=cfg.use_pallas, compute_dtype=compute_dtype,
            kernel_precision=cfg.kernel_precision)
        assert x.dtype == FP32
        if keep is not None:
            x = x * keep / (1.0 - cfg.dropout)
        if li < cfg.gat_num_layers - 1:
            x = F.elu(x)
    return apply_projection_head(
        params["projection"], x, dropout_rate=cfg.projection_dropout,
        train=train, rng=rng, compute_dtype=compute_dtype)


def _model_run(cfg, step, device, train=True):
    """The stack's output, the gradient of every parameter under a fixed
    cotangent, and the generators' states after it."""
    x, g = _graph(cfg, device=device)
    params = init_model(cfg, seed=4, device=device)
    leaves = [p.requires_grad_() for p in tree_leaves(
        [params["layers"], params["projection"]])]
    rng = RngStreams.from_seed(6, device)
    out = step(params, cfg, x, g, train=train, rng=rng)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(8))
    grads = torch.autograd.grad(out, leaves, cot.to(device))
    return ([out.detach()] + list(grads),
            [rng.host.get_state(), rng.device.get_state()])


@pytest.mark.parametrize("compute_dtype", ("bfloat16", "float32"))
@pytest.mark.parametrize("use_pallas", (False, True), ids=("plain",
                                                           "kernels"))
@pytest.mark.parametrize("train", (True, False), ids=("train", "eval"))
def test_stack_equals_the_written_out_stack(compute_dtype, use_pallas, train,
                                            one_thread):
    """Two GAT layers and a two-layer head, dropout on: the output, every
    parameter's gradient and the generators' states equal, bit for bit,
    those of the stack written out as it was before the tail."""
    cfg = ModelConfig(**MODEL, compute_dtype=compute_dtype,
                      use_pallas=use_pallas)
    got, got_rng = _model_run(cfg, single_gat_step, "cpu", train)
    want, want_rng = _model_run(cfg, written_out_gat_step, "cpu", train)
    for a, b in zip(got + got_rng, want + want_rng):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _step(remat, compute_dtype, use_pallas):
    cfg = ModelConfig(**MODEL, compute_dtype=compute_dtype, remat=remat,
                      use_pallas=use_pallas)
    tc = TrainConfig(train_batch_size=16, num_neg=4, lr=1e-3,
                     lr_scheduler="constant", warmup_steps=0,
                     eval_ks_ranks=(1,))
    x, g = _graph(cfg, seed=2)
    opt = make_optimizer(tc, make_lr_schedule(tc.lr, "constant", 10, 0))
    state = create_train_state(init_model(cfg, seed=3, device="cpu"), opt,
                               seed=5)
    rng = np.random.default_rng(7)
    batch = [torch.from_numpy(rng.integers(0, n, 16))
             for n in (N, R, N)] + [torch.ones(16)]
    loss, _, grads = loss_and_grads(state.params, cfg, tc, x, g, *batch,
                                    rng=state.rng)
    return ([loss] + tree_leaves(grads),
            [state.rng.host.get_state(), state.rng.device.get_state()])


@pytest.mark.parametrize("compute_dtype", ("bfloat16", "float16"))
@pytest.mark.parametrize("use_pallas", (False, True), ids=("plain",
                                                           "kernels"))
def test_remat_equals_no_remat_in_half_types(compute_dtype, use_pallas,
                                             one_thread):
    """With the layers' outputs in a half type and every dropout on, a step
    under remat gives the loss, gradients and generator states of the step
    without it, bit for bit."""
    got, got_rng = _step(True, compute_dtype, use_pallas)
    want, want_rng = _step(False, compute_dtype, use_pallas)
    for a, b in zip(got + got_rng, want + want_rng):
        assert torch.equal(a, b)


def test_gate():
    """What the kernels take: contiguous fp32 agg and keep of one shape on
    one device, an fp32, bf16 or fp16 output and cotangent; anything else
    is a ValueError that names it."""
    agg, keep = torch.zeros(3, 8), torch.ones(3, 8)
    lt.check_tail(agg, keep, BF16)
    lt.check_tail(agg, None, FP32)
    lt.check_tail(torch.zeros(5, 901)[1:], torch.ones(4, 901), FP16)
    lt.check_cotangent(torch.zeros(3, 8, dtype=BF16), keep, agg)
    lt.check_cotangent(torch.zeros(3, 8), None, None)
    for args, says in (
            ((agg.t(), keep.t(), BF16), "not contiguous"),
            ((agg, keep.t().contiguous().t(), BF16), "not contiguous"),
            ((agg.double(), keep, BF16), "agg is torch.float64"),
            ((agg.bfloat16(), keep, BF16), "agg is torch.bfloat16"),
            ((agg, keep.half(), BF16), "keep is torch.float16"),
            ((agg, keep[:2], BF16), "keep is"),
            ((torch.zeros(0, 8), None, BF16), "empty"),
            ((agg, keep, torch.float64), "output of")):
        with pytest.raises(ValueError, match=says):
            lt.check_tail(*args)
    for args, says in (
            ((torch.zeros(3, 8, dtype=torch.float64), keep, None),
             "cotangent is torch.float64"),
            ((torch.zeros(8, 3).t(), keep, None), "not contiguous"),
            ((torch.zeros(3, 8), keep.bfloat16(), None), "keep is"),
            ((torch.zeros(3, 8), keep, agg[:, :4]), "agg is")):
        with pytest.raises(ValueError, match=says):
            lt.check_cotangent(*args)
    for fn, args in ((lt.layer_tail_fwd, (agg, keep, 0.3, True, BF16)),
                     (lt.layer_tail_bwd, (agg, keep, agg, 0.3, True))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


def test_counters_reset():
    lt.layer_tail_fwd.launches, lt.layer_tail_bwd.launches = 3, 2
    assert lt.tail_counts() == {"layer_tail_fwd": 3, "layer_tail_bwd": 2}
    lt.reset_tail_counts()
    assert lt.tail_counts() == {"layer_tail_fwd": 0, "layer_tail_bwd": 0}


# ---------------------------------------------------------------------------
# Card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counted(fn):
    before = lt.tail_counts()
    res = fn()
    torch.cuda.synchronize()
    after = lt.tail_counts()
    return res, {k: after[k] - before[k] for k in after}


@pytest.mark.gpu
@pytest.mark.parametrize("width", (2048, 3072, 3600, 901))
@pytest.mark.parametrize("rate", (0.25, 0.3))
@pytest.mark.parametrize("elu", (True, False))
@pytest.mark.parametrize("out_dtype", (BF16, FP32, FP16))
@pytest.mark.parametrize("masked", (True, False), ids=("keep", "no-keep"))
def test_kernels_equal_the_eager_chain(card, width, rate, elu, out_dtype,
                                       masked):
    """Forward and backward, the kernels give the eager chain's bits on the
    card; one launch each."""
    n = 1001 if width == 901 else 700  # 901 * 1001: no multiple of 8
    agg, keep, g = _rows(n, width, rate, seed=width, device="cuda")
    keep = keep if masked else None
    if not masked and not elu and out_dtype == FP32:
        got, counts = _counted(lambda: _value_and_grad(
            _tail, agg, keep, rate, elu, out_dtype, g))
        assert counts == {"layer_tail_fwd": 0, "layer_tail_bwd": 0}
    else:
        got, counts = _counted(lambda: _value_and_grad(
            _tail, agg, keep, rate, elu, out_dtype, g))
        assert counts == {"layer_tail_fwd": 1, "layer_tail_bwd": 1}
    want = _value_and_grad(eager_chain, agg, keep, rate, elu, out_dtype, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b), int((a != b).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", (BF16, FP32))
@pytest.mark.parametrize("elu", (True, False))
def test_unaligned_views_equal_the_eager_chain(card, out_dtype, elu):
    """Views that start 4 bytes past a 16-byte boundary (the scalar path)
    give the bits of the aligned path and of the eager chain."""
    n, d = 301, 2048
    agg, keep, g = _rows(n, d, 0.3, seed=5, device="cuda")
    shift = []
    for t in (agg, keep, g):
        buf = torch.empty(t.numel() + 1, device="cuda")
        buf[1:] = t.reshape(-1)
        shift.append(buf[1:].view(n, d))
    assert all(t.data_ptr() % 16 == 4 for t in shift)
    got = _value_and_grad(_tail, *shift[:2], 0.3, elu, out_dtype, shift[2])
    aligned = _value_and_grad(_tail, agg, keep, 0.3, elu, out_dtype, g)
    want = _value_and_grad(eager_chain, agg, keep, 0.3, elu, out_dtype, g)
    for a, b, c in zip(got, aligned, want):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.gpu
def test_card_raises_on_what_the_kernels_do_not_take(card):
    """A mask on another device, a wrong type, a non-contiguous view: a
    ValueError, and no kernel launches."""
    agg, keep, _ = _rows(64, 40, 0.3, seed=1, device="cuda")
    for args, says in (
            ((agg, keep.cpu()), "keep is"),
            ((agg.half(), keep), "agg is torch.float16"),
            ((agg.t(), keep.t()), "not contiguous")):
        before = lt.tail_counts()
        with pytest.raises(ValueError, match=says):
            lt.layer_tail(*args, 0.3, elu=True, out_dtype=BF16)
        assert lt.tail_counts() == before
    with pytest.raises(ValueError, match="output of"):
        lt.layer_tail(agg, keep, 0.3, elu=True, out_dtype=torch.float64)
    with pytest.raises(ValueError, match="cotangent is"):
        lt.layer_tail_bwd(agg.double(), keep, agg, 0.3, True)


@pytest.mark.gpu
def test_no_grad_launches_forward_only(card):
    agg, keep, _ = _rows(100, 2048, 0.3, seed=2, device="cuda")
    with torch.no_grad():
        out, counts = _counted(lambda: lt.layer_tail(
            agg.requires_grad_(), keep, 0.3, elu=True, out_dtype=BF16))
    assert out.dtype == BF16 and not out.requires_grad
    assert counts == {"layer_tail_fwd": 1, "layer_tail_bwd": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ("bfloat16", "float32"))
@pytest.mark.parametrize("remat", (False, True), ids=("", "remat"))
def test_stack_on_card_equals_the_written_out_stack(card, compute_dtype,
                                                    remat):
    """Two GAT layers on the card's kernels, dropout on: output, gradients
    and generator states equal, bit for bit, the stack written out as it
    was before the tail, on the card; one forward (two under remat) and one
    backward launch a layer."""
    cfg = ModelConfig(**MODEL, compute_dtype=compute_dtype, use_pallas=True,
                      remat=remat)
    (got, got_rng), counts = _counted(
        lambda: _model_run(cfg, single_gat_step, "cuda"))
    assert counts == {"layer_tail_fwd": 4 if remat else 2,
                      "layer_tail_bwd": 2}
    want, want_rng = _model_run(cfg, written_out_gat_step, "cuda")
    for a, b in zip(got + got_rng, want + want_rng):
        assert a.dtype == b.dtype and torch.equal(a, b)
