"""The head's GELU -> LayerNorm block (``ops/cuda/gelu_layernorm.py``).

On the CPU: ``apply_projection_head`` takes the plain composition bit for bit
and launches nothing; the closed-form backward the kernels implement
(``closed_form`` below, in PyTorch) matches autograd of the plain composition
(to 1e-10 in float64, to fp32 rounding in fp32); the gate of the
kernels. No JAX here.

Marked ``gpu`` (each skips without a CUDA device, decided inside the test):
the kernels against the plain composition on the card. Run them from the
repository root, without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gelu_layernorm.py

There both the kernels and the plain composition run in fp32 and are held to
the plain composition in float64 on the same inputs: the kernels' error may
be at most twice the plain fp32 composition's, or 1e-5 of the largest value,
whichever is larger (the two differ only in the order of the row sums).
"""

import math

import pytest
import torch
import torch.nn.functional as F

from relgat_projector_tpu_torch.device import compute_matmul
from relgat_projector_tpu_torch.models.projection import (
    apply_projection_head,
    init_projection_head,
)
from relgat_projector_tpu_torch.ops.cuda import gelu_layernorm as gln
from relgat_projector_tpu_torch.utils.rng import RngStreams

REL_TOL = 1e-5
WIDTHS = (2048, 1152, 1004, 1001)  # 1004: a multiple of 4, not of 8


def _layer_norm(x, scale, bias):
    """The head's LayerNorm as written in the port before the kernels."""
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * scale + bias


def closed_form(y, scale, bias, dz):
    """``(z, dy, dscale, dbias)`` as the kernels compute them, in ``y``'s
    type: mean as sum * (1 / D), the variance two-pass, then
    dg = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) with
    dxhat = dz * scale, and PyTorch's exact-GELU derivative."""
    t = y.dtype
    scale, bias, dz = scale.to(t), bias.to(t), dz.to(t)
    inv_d = 1.0 / torch.tensor(float(y.shape[-1]), dtype=t)
    alpha = torch.tensor(math.sqrt(0.5), dtype=t)
    beta = torch.tensor(2.0 / math.sqrt(math.pi) * math.sqrt(0.5) * 0.5,
                        dtype=t)
    g = y * 0.5 * (1 + torch.erf(y * alpha))
    mean = g.sum(-1, keepdim=True) * inv_d
    c = g - mean
    rstd = torch.rsqrt((c * c).sum(-1, keepdim=True) * inv_d + 1e-5)
    xhat = c * rstd
    z = xhat * scale + bias
    dxhat = dz * scale
    m1 = dxhat.sum(-1, keepdim=True) * inv_d
    m2 = (dxhat * xhat).sum(-1, keepdim=True) * inv_d
    dg = rstd * (dxhat - m1 - xhat * m2)
    cdf = 0.5 * (1 + torch.erf(y * alpha))
    pdf = torch.exp(-0.5 * y * y) * beta
    dy = dg * (cdf + y * pdf)
    return z, dy, (dz * xhat).sum(0), dz.sum(0)


def plain_with_grads(y, scale, bias, dz):
    """``(z, dy, dscale, dbias)`` by autograd of the plain composition."""
    y = y.detach().requires_grad_()
    scale = scale.detach().requires_grad_()
    bias = bias.detach().requires_grad_()
    z = gln.gelu_layer_norm_plain(y, scale, bias)
    grads = torch.autograd.grad(z, (y, scale, bias), dz.to(z.dtype))
    return (z.detach(),) + grads


def _rows(n, d, seed, device="cpu"):
    """Random rows of y, with a constant row (zero variance: rstd is
    1 / sqrt(1e-5)) and a row of large magnitude, scale, bias and dz."""
    gen = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn((n, d), generator=gen, device=device) * 1.5
    y[1] = 0.75
    y[2] *= 3e3
    scale = 1 + 0.2 * torch.randn((d,), generator=gen, device=device)
    bias = 0.1 * torch.randn((d,), generator=gen, device=device)
    dz = torch.randn((n, d), generator=gen, device=device)
    return y, scale, bias, dz


def _err(a, ref):
    return float((a.detach().double() - ref.double()).abs().max())


def _no_worse(got, plain, ref, what):
    """``got`` no further from ``ref`` than twice the plain fp32 version, or
    1e-5 of ``ref``'s largest value."""
    bar = max(2 * _err(plain, ref), REL_TOL * float(ref.abs().max()))
    assert _err(got, ref) <= bar, (what, _err(got, ref), _err(plain, ref))


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("param_dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("layers,train", ((2, False), (3, True)))
def test_head_takes_plain_path_on_cpu(compute_dtype, param_dtype, layers,
                                      train):
    """The head's output and gradients equal, bit for bit, the composition
    written out here, and no kernel launches."""
    gen = torch.Generator().manual_seed(3)
    params = init_projection_head(gen, 24, 40, layers, hidden_dim=36)
    params = {k: [p.to(param_dtype).requires_grad_() for p in v]
              for k, v in params.items()}
    x = torch.randn((50, 24), generator=gen)
    gln.reset_head_counts()

    def written_out():
        rng = RngStreams.from_seed(5, "cpu")
        y = x
        for i, w in enumerate(params["linears"]):
            y = compute_matmul(y, w, compute_dtype)
            if i < len(params["ln_scale"]):
                y = _layer_norm(F.gelu(y, approximate="none"),
                                params["ln_scale"][i], params["ln_bias"][i])
        if train:
            keep = y.new_empty(y.shape).bernoulli_(1.0 - 0.3,
                                                   generator=rng.device)
            y = y * keep / (1.0 - 0.3)
        return y

    got = apply_projection_head(
        params, x, dropout_rate=0.3, train=train,
        rng=RngStreams.from_seed(5, "cpu"), compute_dtype=compute_dtype)
    want = written_out()
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    leaves = [p for v in params.values() for p in v]
    cot = torch.randn(got.shape, generator=gen)
    for a, b in zip(torch.autograd.grad(got, leaves, cot),
                    torch.autograd.grad(want, leaves, cot)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert gln.head_counts() == {"gelu_layer_norm_fwd": 0,
                                 "gelu_layer_norm_bwd": 0}


@pytest.mark.parametrize("d", (64, 1152, 37))
def test_closed_form_is_the_gradient_in_float64(d):
    y, scale, bias, dz = (t.double() for t in _rows(33, d, seed=d))
    got = closed_form(y, scale, bias, dz)
    want = plain_with_grads(y, scale, bias, dz)
    for name, a, b in zip(("z", "dy", "dscale", "dbias"), got, want):
        scale_of = float(b.abs().max())
        assert _err(a, b) <= 1e-10 * scale_of, (name, _err(a, b))


@pytest.mark.parametrize("d", (2048, 1152, 1001))
@pytest.mark.parametrize("param_dtype", (torch.float32, torch.bfloat16))
def test_closed_form_matches_autograd_in_fp32(d, param_dtype):
    """The kernels' arithmetic in fp32 is as close to the float64 gradient
    as autograd of the plain composition in fp32 is (twice its error, or
    1e-5 of the largest value), scale and bias gradients included."""
    y, scale, bias, dz = _rows(24, d, seed=d + 1)
    scale, bias = scale.to(param_dtype), bias.to(param_dtype)
    got = closed_form(y, scale, bias, dz)
    plain = plain_with_grads(y, scale.float(), bias.float(), dz)
    ref = plain_with_grads(y.double(), scale.double(), bias.double(),
                           dz.double())
    for name, a, p, r in zip(("z", "dy", "dscale", "dbias"), got, plain, ref):
        assert a.dtype == torch.float32
        _no_worse(a, p, r, name)


def test_gate():
    """What the kernels take: fp32 contiguous y at most MAX_WIDTH wide, any
    leading shape, fp32, bf16 or fp16 scale and bias of y's width; anything
    else is a ValueError that names the limit."""
    def gate(y, s=None, b=None, out=torch.bfloat16):
        d = y.shape[-1]
        s = torch.ones(d) if s is None else s
        b = torch.zeros(d) if b is None else b
        gln.check_block(y, s, b, out)

    gate(torch.zeros(3, 2048))
    gate(torch.zeros(2, 3, 1001), out=torch.float32)
    gate(torch.zeros(3, gln.MAX_WIDTH))
    gate(torch.zeros(3, 8), torch.ones(8, dtype=torch.bfloat16),
         torch.zeros(8, dtype=torch.float16))
    gate(torch.zeros(3, 8), torch.ones(16)[::2])  # widened densely
    for args, kw, says in (
            ((torch.zeros(3, gln.MAX_WIDTH + 1),), {}, "8192"),
            ((torch.zeros(3, 8, dtype=torch.float64),), {}, "fp32"),
            ((torch.zeros(3, 8, dtype=torch.bfloat16),), {}, "fp32"),
            ((torch.zeros(8, 3).t(),), {}, "contiguous"),
            ((torch.zeros(0, 8),), {}, "rows"),
            ((torch.zeros(3, 8), torch.ones(8, dtype=torch.float64)), {},
             "scale"),
            ((torch.zeros(3, 8), torch.ones(9)), {}, "scale"),
            ((torch.zeros(3, 8), None, torch.ones(9)), {}, "bias"),
            ((torch.zeros(3, 8),), {"out": torch.float64}, "z of")):
        with pytest.raises(ValueError, match=says):
            gate(*args, **kw)


def test_strided_scale_is_widened_densely():
    """A strided fp32 view of scale or bias reaches the kernels as a dense
    copy (they read a dense array)."""
    t = torch.arange(16.0)[::2]
    w = gln._widened(t)
    assert w.is_contiguous() and torch.equal(w, t)
    assert gln._widened(torch.ones(4, dtype=torch.bfloat16)).dtype \
        == torch.float32


# ---------------------------------------------------------------------------
# Card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fused(y, scale, bias, dz, out_dtype):
    """``(z, dy, dscale, dbias)`` through ``gelu_layer_norm`` on the card,
    with the counters' increase."""
    before = gln.head_counts()
    y = y.detach().requires_grad_()
    scale = scale.detach().requires_grad_()
    bias = bias.detach().requires_grad_()
    z = gln.gelu_layer_norm(y, scale, bias, out_dtype)
    grads = torch.autograd.grad(z, (y, scale, bias), dz.to(z.dtype))
    torch.cuda.synchronize()
    after = gln.head_counts()
    return ((z.detach(),) + grads,
            {k: after[k] - before[k] for k in after})


@pytest.mark.gpu
@pytest.mark.parametrize("d", WIDTHS + (4096, gln.MAX_WIDTH))
@pytest.mark.parametrize("out_dtype", (torch.float32, torch.bfloat16,
                                       torch.float16))
@pytest.mark.parametrize("param_dtype", (torch.float32, torch.bfloat16))
def test_kernels_match_plain(card, d, out_dtype, param_dtype):
    n = 3000 if d <= 2048 else 600
    y, scale, bias, dz = _rows(n, d, seed=d, device="cuda")
    scale, bias = scale.to(param_dtype), bias.to(param_dtype)
    # dz arrives in z's type (autograd casts the cotangent to it)
    dz = dz.to(out_dtype)
    (z, dy, dscale, dbias), counts = _fused(y, scale, bias, dz, out_dtype)
    assert counts == {"gelu_layer_norm_fwd": 1, "gelu_layer_norm_bwd": 1}
    assert z.dtype == out_dtype and dy.dtype == torch.float32
    assert dscale.dtype == dbias.dtype == param_dtype
    plain = plain_with_grads(y, scale, bias, dz.float())
    ref = plain_with_grads(y.double(), scale.double(), bias.double(),
                           dz.double())
    z_plain = plain[0].to(out_dtype)
    for name, a, p, r in zip(("z", "dy", "dscale", "dbias"),
                             (z, dy, dscale, dbias),
                             (z_plain,) + plain[1:], ref):
        _no_worse(a, p, r, name)
    if out_dtype != torch.float32:
        # z rounds as compute_matmul's cast of the plain fp32 z: a rounding
        # flips only where the two fp32 values straddle a boundary (past
        # the constant row, whose z is bias plus rounding noise times rstd)
        flips = (z[3:] != z_plain[3:]).float().mean()
        assert float(flips) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("d", (2048, 1001))
def test_param_grads_same_bits_twice(card, d):
    y, scale, bias, dz = _rows(20000, d, seed=7, device="cuda")
    first, _ = _fused(y, scale, bias, dz.bfloat16(), torch.bfloat16)
    second, _ = _fused(y, scale, bias, dz.bfloat16(), torch.bfloat16)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_card_raises_past_the_gate(card):
    """Past MAX_WIDTH, and for a non-contiguous y, the card raises a
    ValueError naming the limit; no kernel launches."""
    for y, says in ((torch.randn((5, gln.MAX_WIDTH + 1), device="cuda"),
                     "8192"),
                    (torch.randn((64, 5), device="cuda").t(), "contiguous")):
        d = y.shape[-1]
        scale = torch.rand(d, device="cuda")
        bias = torch.rand(d, device="cuda")
        before = gln.head_counts()
        with pytest.raises(ValueError, match=says):
            gln.gelu_layer_norm(y, scale, bias, torch.bfloat16)
        assert gln.head_counts() == before


@pytest.mark.gpu
def test_strided_scale_on_card(card):
    """A strided fp32 scale and bias give the values of their dense copies."""
    y, scale, bias, dz = _rows(300, 1152, seed=4, device="cuda")
    wide = torch.stack((scale, -scale), 1).reshape(-1)[::2]
    wide_b = torch.stack((bias, -bias), 1).reshape(-1)[::2]
    assert not wide.is_contiguous()
    got, _ = _fused(y, wide, wide_b, dz, torch.float32)
    want, _ = _fused(y, scale, bias, dz, torch.float32)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_no_grad_launches_forward_only(card):
    y, scale, bias, _ = _rows(100, 2048, seed=1, device="cuda")
    before = gln.head_counts()
    with torch.no_grad():
        z = gln.gelu_layer_norm(y, scale.requires_grad_(), bias,
                                torch.bfloat16)
    after = gln.head_counts()
    assert z.dtype == torch.bfloat16 and not z.requires_grad
    assert after["gelu_layer_norm_fwd"] == before["gelu_layer_norm_fwd"] + 1
    assert after["gelu_layer_norm_bwd"] == before["gelu_layer_norm_bwd"]


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", (torch.float32, torch.bfloat16))
def test_head_launches_once_a_block(card, compute_dtype):
    """A 3-layer head (two hidden blocks) forward and backward on the card:
    two launches of each kernel, and the output and gradients
    within bf16 rounding of the same head on the CPU."""
    gen = torch.Generator().manual_seed(2)
    params = init_projection_head(gen, 96, 80, 3, hidden_dim=256)
    x = torch.randn((700, 96), generator=gen)
    cot = torch.randn((700, 80), generator=gen)

    def run(device):
        p = {k: [t.to(device).requires_grad_() for t in v]
             for k, v in params.items()}
        out = apply_projection_head(p, x.to(device),
                                    compute_dtype=compute_dtype)
        leaves = [t for v in p.values() for t in v]
        grads = torch.autograd.grad(out, leaves, cot.to(device))
        return [out.cpu()] + [g.cpu() for g in grads]

    gln.reset_head_counts()
    on_card = run("cuda")
    assert gln.head_counts() == {"gelu_layer_norm_fwd": 2,
                                 "gelu_layer_norm_bwd": 2}
    tol = 1e-5 if compute_dtype == torch.float32 else 2e-2
    for a, b in zip(on_card, run("cpu")):
        assert _err(a, b) <= tol * float(b.abs().max())
