"""The port's bf16 mode (``kernel_precision="default"``, ``compute_dtype=
"bfloat16"``) against the JAX package's, on the CPU.

What the mode computes: the propagate reads ``h`` rounded to bf16 once at
node size, and the backward ``g`` rounded to bf16 after ``S`` and ``gsum``
are taken from the fp32 ``g``; all arithmetic, the statistics and every
output are fp32. With ``compute_dtype="bfloat16"`` each projection takes
bf16 operands and gives fp32. Inputs are made with numpy from a seed and
handed to both packages; the JAX Pallas kernels run in interpret mode, where
their "default" dots are fp32, so both sides compute "bf16 inputs, fp32
arithmetic".

Tolerances:

- propagate, port against JAX: forward rtol 1e-4 / atol 1e-5 (sums in
  another order); dh, dattn, dbias within 1e-3 of the largest value: the
  port keeps the statistics in fp32 where the TPU layout packs them as bf16
  (hi, lo) pairs of ~16 mantissa bits;
- the port's bf16-vs-fp32 gap equals JAX's own gap on the same inputs to
  1e-4 (in the same relative-to-max units);
- each plain bf16 version equals its fp32 plain version fed the
  bf16-rounded rows to 1e-6 (float64 split route: 1e-12);
- the full train step, port against JAX: loss 1e-3 relative, every
  gradient 1e-2 of its largest value. The port's product of bf16 operands
  comes back in fp32, as JAX's does, and its backward products round their
  results to bf16 where JAX's VJP does; the one rounding left is the
  cotangent, a bf16 operand of the port's backward products (the tensor
  cores' type, and a TPU's at default precision) where JAX on the CPU
  keeps it fp32. Measured 9.2e-3, 6.6e-3 and 7.9e-3 (gradients) at seeds
  13, 14 and 15; before the product came back in fp32 it gave 1.27e-2;
- the same step with the cotangent kept fp32 (a test-local backward):
  every gradient 1e-3 of its largest value. Measured 3.3e-4, 7.9e-4 and
  9.6e-4 at seeds 13, 14 and 15;
- ``compute_matmul`` in bf16 against the float64 product of the
  bf16-rounded operands: 1e-6 relative (fp32 sums of exact products over
  a few hundred terms), and the result is not bf16-rounded.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu.config import ModelConfig as JaxModelConfig
from relgat_projector_tpu.config import TrainConfig as JaxTrainConfig
from relgat_projector_tpu.data.blocked import build_blocked_graph
from relgat_projector_tpu.data.graph import build_graph as jax_build_graph
from relgat_projector_tpu.models.model import init_model as jax_init_model
from relgat_projector_tpu.ops.dropout import seed_from_key
from relgat_projector_tpu.ops.pallas import relgat_propagate_pallas
from relgat_projector_tpu.ops.sampling import sample_negative_dst
from relgat_projector_tpu.train import step as jax_step
from relgat_projector_tpu_torch import cli, device
from relgat_projector_tpu_torch.config import ModelConfig, RunConfig, TrainConfig
from relgat_projector_tpu_torch.data.csr import FWD_ITEM_EDGES
from relgat_projector_tpu_torch.data.graph import build_graph, pad_node_embeddings
from relgat_projector_tpu_torch.device import compute_matmul
from relgat_projector_tpu_torch.interop import params_from_jax
from relgat_projector_tpu_torch.ops import cuda as kern
from relgat_projector_tpu_torch.ops.relgat_ops import relgat_propagate
from relgat_projector_tpu_torch.train.step import loss_and_grads
from relgat_projector_tpu_torch.utils.tree import tree_leaves

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = 1e-3
GAP_TOL = 1e-4
PLAIN_TOL = 1e-6
STEP_LOSS_TOL = 1e-3
STEP_GRAD_TOL = 1e-2
FP32_COTANGENT_GRAD_TOL = 1e-3
MATMUL_TOL = 1e-6
HUB, HUB_DEGREE = 7, 300   # one row split by the forward's work plan
CASES = ("rate0_bias", "rate0_no_bias", "rate0.3_bias", "rate0.3_no_bias")
DROPOUT_KEY = 3


def _rel(a, b):
    """max|a - b| / max|b| over the finite entries, which must lie where
    b's do (m is -inf on rows without in-edges)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin) and np.array_equal(
        a[~fin], b[~fin])
    a, b = a[fin], b[fin]
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _bf16(a):
    """numpy fp32 -> its bf16 rounding (round to nearest even), as fp32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@functools.lru_cache(maxsize=None)
def _propagate_inputs():
    rng = np.random.default_rng(0)
    n, e, r, heads, f = 300, 2500, 6, 4, 16
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    dst[:HUB_DEGREE] = HUB
    et = rng.integers(0, r, e)
    g = build_graph(src, dst, et, n, num_rel=r, csr=True, device="cpu")
    n_pad = g.num_nodes
    h = (rng.standard_normal((n_pad, heads, f)) * 0.5).astype(np.float32)
    attn = (rng.standard_normal((heads, r, f)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(r) * 0.1).astype(np.float32)
    wsum = rng.standard_normal((n_pad, heads, f)).astype(np.float32)
    return g, h, attn, bias, wsum


def _case(case):
    rate = 0.3 if case.startswith("rate0.3") else 0.0
    return rate, not case.endswith("no_bias")


@functools.lru_cache(maxsize=None)
def _jax_propagate(case, precision):
    """(out, grads) of JAX's Pallas propagate in interpret mode."""
    g, h, attn, bias, wsum = _propagate_inputs()
    rate, with_bias = _case(case)
    key = jax.random.PRNGKey(DROPOUT_KEY) if rate else None
    csr = g.csr
    blocked = build_blocked_graph(
        csr.src.numpy(), csr.dst.numpy(), csr.etype.numpy(),
        num_nodes=g.num_nodes, block_nodes=32, chunk_edges=128,
    )

    def fn(h_, a_, b_=None):
        return relgat_propagate_pallas(
            h_, a_, b_, blocked, attn_dropout_rate=rate, dropout_rng=key,
            kernel_precision=precision,
        )

    args = [jnp.asarray(h), jnp.asarray(attn)]
    if with_bias:
        args.append(jnp.asarray(bias))
    out = np.asarray(fn(*args))
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a)) * wsum),
                     argnums=tuple(range(len(args))))(*args)
    return out, [np.asarray(x) for x in grads]


def _port_propagate(case, precision):
    g, h, attn, bias, wsum = _propagate_inputs()
    rate, with_bias = _case(case)
    seed = int(seed_from_key(jax.random.PRNGKey(DROPOUT_KEY))) if rate else None
    leaves = [torch.tensor(h, requires_grad=True),
              torch.tensor(attn, requires_grad=True)]
    if with_bias:
        leaves.append(torch.tensor(bias, requires_grad=True))
    out = relgat_propagate(
        leaves[0], leaves[1], leaves[2] if with_bias else None,
        g.src, g.dst, g.etype, num_nodes=g.num_nodes,
        attn_dropout_rate=rate, dropout_seed=seed, use_pallas=True,
        csr=g.csr, kernel_precision=precision,
    )
    (torch.sin(out) * torch.from_numpy(wsum)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


def test_propagate_graph_has_a_split_row():
    g = _propagate_inputs()[0]
    assert int(np.bincount(g.csr.dst.numpy())[HUB]) > FWD_ITEM_EDGES
    assert g.csr.fwd_num_split >= 1


@pytest.mark.parametrize("case", CASES)
def test_bf16_propagate_matches_jax_default(case):
    out, grads = _port_propagate(case, "default")
    want_out, want_grads = _jax_propagate(case, "default")
    np.testing.assert_allclose(out, want_out, **FWD_TOL)
    assert len(grads) == len(want_grads)
    for name, got, want in zip(("dh", "dattn", "dbias"), grads, want_grads):
        assert _rel(got, want) <= GRAD_TOL, (name, _rel(got, want))


@pytest.mark.parametrize("case", ("rate0_bias", "rate0.3_bias"))
def test_bf16_gap_to_fp32_equals_jax(case):
    """The bf16 mode moves the result away from fp32 exactly as the JAX
    package's bf16 mode does on the same inputs (out, dh, dattn, dbias)."""
    port = [_port_propagate(case, p) for p in ("default", "highest")]
    ref = [_jax_propagate(case, p) for p in ("default", "highest")]
    port_gap = [_rel(a, b) for a, b in zip([port[0][0]] + port[0][1],
                                           [port[1][0]] + port[1][1])]
    jax_gap = [_rel(a, b) for a, b in zip([ref[0][0]] + ref[0][1],
                                          [ref[1][0]] + ref[1][1])]
    assert max(port_gap) > 1e-3  # the mode does round
    np.testing.assert_allclose(port_gap, jax_gap, rtol=0, atol=GAP_TOL)


# ---------------------------------------------------------------------------
# The plain bf16 versions
# ---------------------------------------------------------------------------

def _kernel_inputs(rate):
    g, h, attn, bias, wsum = _propagate_inputs()
    n = g.num_nodes
    hf = h.shape[1] * h.shape[2]
    rng = np.random.default_rng(1)
    gr = rng.standard_normal((n, hf)).astype(np.float32)
    kw = dict(seed=-987654321, rate=rate, negative_slope=0.2, eps=1e-16)
    return g.csr, h.reshape(n, hf), gr, attn, bias, kw


@pytest.mark.parametrize("kernel", ("fwd", "bwd_src", "bwd_rel"))
@pytest.mark.parametrize("rate", (0.0, 0.3))
def test_plain_bf16_versions_equal_fp32_on_rounded_rows(kernel, rate):
    csr, h, gr, attn, bias, kw = _kernel_inputs(rate)
    t = torch.from_numpy
    h16, g16 = t(h).to(torch.bfloat16), t(gr).to(torch.bfloat16)
    hr, gr_r = t(_bf16(h)), t(_bf16(gr))
    attn, bias = t(attn), t(bias)
    n, heads = h.shape[0], attn.shape[0]
    m, l, s_dot = (t(np.random.default_rng(i).random((n, heads), np.float32))
                   for i in (2, 3, 4))
    gsum = gr_r.sum(1)
    if kernel == "fwd":
        got = kern.relgat_fwd_bf16_plain(h16, attn, bias, csr, **kw)
        want = kern.relgat_fwd_plain(hr, attn, bias, csr, **kw)
    elif kernel == "bwd_src":
        args = (attn, m + 1.0, l + 1.0, s_dot, gsum, csr)
        got = kern.relgat_bwd_src_bf16_plain(h16, g16, *args, **kw)
        want = kern.relgat_bwd_src_plain(hr, gr_r, *args, **kw)
    else:
        w = t(np.random.default_rng(5).standard_normal(
            (n, heads, attn.shape[1])).astype(np.float32))
        b = t(np.random.default_rng(6).standard_normal(
            (n, attn.shape[1])).astype(np.float32))
        got = kern.relgat_bwd_rel_bf16_plain(h16, w, b)
        want = kern.relgat_bwd_rel_plain(hr, w, b)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert _rel(a.numpy(), b.numpy()) <= PLAIN_TOL


@pytest.mark.parametrize("rate", (0.0, 0.3))
def test_bf16_split_route_matches_plain(rate):
    """The kernels' split-row route (``relgat_fwd_split_plain``) on the
    bf16-rounded rows, in float64, equals the plain bf16 version."""
    csr, h, _, attn, bias, kw = _kernel_inputs(rate)
    t = torch.from_numpy
    h16 = t(h).to(torch.bfloat16)
    got = kern.relgat_fwd_split_plain(h16.double(), t(attn).double(),
                                      t(bias).double(), csr, **kw)
    want = kern.relgat_fwd_bf16_plain(h16, t(attn).double(),
                                      t(bias).double(), csr, **kw)
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b.numpy()) <= 1e-12


def test_cpu_wrappers_take_bf16_rows_through_their_plain_versions():
    csr, h, gr, attn, bias, kw = _kernel_inputs(0.3)
    t = torch.from_numpy
    h16, g16 = t(h).to(torch.bfloat16), t(gr).to(torch.bfloat16)
    attn, bias = t(attn), t(bias)
    before = kern.launch_counts()
    out, m, l, b = kern.relgat_fwd_bf16(h16, attn, bias, csr, **kw)
    n, heads = h.shape[0], attn.shape[0]
    s_dot = ((out - b[:, None]) * t(gr)).view(n, heads, -1).sum(-1)
    dh, w, bb = kern.relgat_bwd_src_bf16(h16, g16, attn, m, l, s_dot,
                                         t(gr).sum(1), csr, **kw)
    dattn, dbias = kern.relgat_bwd_rel_bf16(h16, w, bb)
    assert kern.launch_counts() == before
    assert m.dtype == torch.float32  # -inf on rows without in-edges
    for x in (out, l, b, dh, w, bb, dattn, dbias):
        assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
    want = kern.relgat_fwd_bf16_plain(h16, attn, bias, csr, **kw)
    assert torch.equal(out, want[0])


# ---------------------------------------------------------------------------
# The train step, the config and the CLI
# ---------------------------------------------------------------------------

N, E, R, D, B, K = 100, 500, 4, 16, 32, 5
BF16_MODE = dict(use_pallas=True, kernel_precision="default",
                 compute_dtype="bfloat16")


def _train_step_errors(seed):
    """Loss error (relative) and each gradient's error (relative to its
    largest value) of the port's bf16 training forward and backward against
    JAX's, on shared weights and the JAX step's own negatives (dropout
    off)."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    et = rng.integers(0, R, E)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    batch = [rng.integers(0, N, B), rng.integers(0, R, B), rng.integers(0, N, B)]
    model = dict(in_dim=D, num_rel=R, gat_out_dim=8, gat_heads=2,
                 gat_num_layers=2, dropout=0.0, projection_layers=2,
                 **BF16_MODE)
    train = dict(train_batch_size=B, num_neg=K, use_self_adv_neg=True)
    jg = jax_build_graph(src, dst, et, N, blocked=True, block_nodes=16,
                         chunk_edges=64)
    jcfg, jtc = JaxModelConfig(**model), JaxTrainConfig(**train)
    jparams = jax_init_model(jax.random.PRNGKey(0), jcfg)
    jx = jnp.asarray(pad_node_embeddings(emb, jg.num_nodes))
    jb = [jnp.asarray(a, jnp.int32) for a in batch] + [jnp.ones((B,), jnp.float32)]
    step_rng = jax.random.PRNGKey(1)
    _, neg_rng = jax.random.split(step_rng)
    neg = sample_negative_dst(neg_rng, jb[2], num_nodes=N, num_neg=K)

    def loss_fn(p):
        return jax_step.batch_forward(p, jcfg, jtc, jx, jg, *jb,
                                      rng=step_rng, train=True)

    (want_loss, _), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jparams)

    g = build_graph(src, dst, et, N, num_rel=R, csr=True, device="cpu")
    loss, _, grads = loss_and_grads(
        params_from_jax(jax.device_get(jparams), device="cpu"),
        ModelConfig(**model), TrainConfig(**train),
        torch.from_numpy(pad_node_embeddings(emb, g.num_nodes)), g,
        *[torch.from_numpy(a) for a in batch], torch.ones(B), rng=None,
        neg_dst=torch.from_numpy(np.asarray(neg).astype(np.int64)),
    )
    want_leaves = jax.tree_util.tree_leaves(want_grads)
    got_leaves = tree_leaves(grads)
    assert len(got_leaves) == len(want_leaves)
    return (abs(float(loss) - float(want_loss)) / abs(float(want_loss)),
            [_rel(a.numpy(), np.asarray(b))
             for a, b in zip(got_leaves, want_leaves)])


@pytest.mark.parametrize("seed", (13, 14))
def test_bf16_train_step_matches_jax(seed):
    """Loss and every gradient of one training forward and backward, port
    against JAX. The port rounds the cotangent of each product to bf16, the
    operand type of a one-pass product at default precision on the tensor
    cores as on a TPU; JAX on the CPU keeps it fp32, which is why the bar
    is ``STEP_GRAD_TOL`` and not ``FP32_COTANGENT_GRAD_TOL``."""
    loss_err, grad_errs = _train_step_errors(seed)
    assert loss_err <= STEP_LOSS_TOL
    assert max(grad_errs) <= STEP_GRAD_TOL, grad_errs


class _Fp32CotangentMatMul(device._CastMatMul):
    """``_CastMatMul`` with the cotangent kept fp32 in its backward
    products, as JAX's VJP keeps it on the CPU; each product is still
    rounded to the operands' type (bf16 or fp16) once."""

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        dx = (g @ wq.float().t()).to(xq.dtype).float()
        dw = (xq.float().t() @ g).to(xq.dtype).float()
        return dx, dw, None


@pytest.mark.parametrize("seed", (13, 14))
def test_bf16_train_step_with_fp32_cotangent_meets_jax_closely(
        seed, monkeypatch):
    """With the cotangent as JAX's CPU VJP has it, every other rounding of
    the bf16 products matches JAX's, so the gradients meet JAX's to
    ``FP32_COTANGENT_GRAD_TOL``: a change to the forward product's rounding
    shows here and cannot hide under ``STEP_GRAD_TOL``."""
    monkeypatch.setattr(device, "_CastMatMul", _Fp32CotangentMatMul)
    loss_err, grad_errs = _train_step_errors(seed)
    assert loss_err <= STEP_LOSS_TOL
    assert max(grad_errs) <= FP32_COTANGENT_GRAD_TOL, grad_errs


@pytest.mark.parametrize("shape", ((64, 300, 96), (4, 16, 200, 48)))
def test_bf16_matmul_is_the_fp32_product_of_rounded_operands(shape):
    """``compute_matmul`` in bf16: the float64 product of the bf16-rounded
    operands to fp32 precision, with leading dimensions kept, never rounded
    to bf16 itself; its gradients are the fp32 products of the bf16
    cotangent and operands, rounded once to bf16, as JAX's VJP rounds
    them."""
    rng = np.random.default_rng(sum(shape))
    *lead, k, m = shape
    x = torch.from_numpy(rng.standard_normal((*lead, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, m)).astype(np.float32))
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = compute_matmul(x, w, torch.bfloat16)
    assert y.dtype == torch.float32 and y.shape == (*lead, m)
    x16, w16 = x.detach().to(torch.bfloat16), w.detach().to(torch.bfloat16)
    want = x16.double() @ w16.double()
    assert _rel(y.detach().numpy(), want.numpy()) <= MATMUL_TOL
    assert not torch.equal(y, y.to(torch.bfloat16).float())
    g = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    y.backward(g)
    g16 = g.to(torch.bfloat16).double().reshape(-1, m)
    dx = (g16 @ w16.double().t()).reshape(x.shape)
    dw = x16.double().reshape(-1, k).t() @ g16
    for got, exact in ((x.grad, dx), (w.grad, dw)):
        assert torch.equal(got, got.to(torch.bfloat16).float())
        assert _rel(got.numpy(), exact.numpy()) <= 2.0 ** -8


def test_config_takes_the_bf16_mode_and_round_trips():
    cfg = ModelConfig(in_dim=8, num_rel=3, **BF16_MODE)
    run = RunConfig(model=cfg)
    back = RunConfig.from_json(run.to_json())
    assert back.model.kernel_precision == "default"
    assert back.model.compute_dtype == "bfloat16"
    jax_run = json.loads(run.to_json())
    assert JaxModelConfig(**jax_run["model"]).to_dict() == cfg.to_dict()
    half = ModelConfig(in_dim=8, num_rel=3, param_dtype="float16",
                       **BF16_MODE)
    assert RunConfig.from_json(RunConfig(model=half).to_json()).model == half
    with pytest.raises(TypeError, match="param_dtype"):
        ModelConfig(in_dim=8, num_rel=3, param_dtype="float17", **BF16_MODE)


def test_cli_trains_saves_and_resumes_in_bf16(tmp_path):
    argv = ["--synthetic", "--synthetic-nodes", "200", "--synthetic-edges",
            "1000", "--synthetic-rels", "3", "--synthetic-dim", "16",
            "--epochs", "1", "--batch-size", "64", "--gat-out-dim", "8",
            "--heads", "2", "--num-neg", "3", "--project-to-input-size",
            "--use-pallas", "--compute-dtype", "bfloat16",
            "--kernel-precision", "default", "--eval-every-n-steps", "4",
            "--save-every-n-steps", "4", "--log-every-n-steps", "5",
            "--save-dir", str(tmp_path), "--device", "cpu"]
    final = tmp_path / "relgat_scorer-distmult_lrscheduler-linear"
    steps = -(-int(0.9 * 1000) // 64)

    def saved():
        state = torch.load(final / "train-state.pt", weights_only=True)
        loop = json.loads((final / "loop-state.json").read_text())
        run = json.loads((final / "training-config.json").read_text())
        params = [t for t in tree_leaves(state["params"])]
        assert all(bool(torch.isfinite(t).all()) for t in params)
        return (int(state["step"]) + int(state["nonfinite_steps"]),
                loop["dispatch_step"], run["model"])

    cli.main(argv)
    done, dispatch, model = saved()
    assert done == dispatch == steps
    assert model["compute_dtype"] == "bfloat16"
    assert model["kernel_precision"] == "default" and model["use_pallas"]
    assert os.path.isfile(final / "relgat-model.pt")
    # --resume reads the same flags and carries the mode on
    cli.main(argv + ["--resume"])
    done, dispatch, model = saved()
    assert done == dispatch == 2 * steps
    assert model["compute_dtype"] == "bfloat16"
    assert model["kernel_precision"] == "default"
    # the checkpoint's own training-config.json feeds back in as --config
    args = cli.get_args(["--config", str(final / "training-config.json"),
                         "--synthetic", "--device", "cpu"])
    got = cli.build_run_config(args).model
    assert (got.compute_dtype, got.kernel_precision) == ("bfloat16", "default")
