"""relgat_bwd_rel_bf16's tensor-core design, on the CPU: its exact split of
fp32 W into three bf16 pieces and the Python side of its dispatch.

On the card the "mma" design computes dattn = W^T h per head as three bf16
tensor-core products, ``hi x h + mid x h + lo x h``, after splitting each
fp32 W value by truncation (``ops.cuda.split_bf16x3`` mirrors the kernel's
split bit for bit). The kernel cannot run here, so these tests hold the
split itself:

- ``hi + mid + lo == W`` bit for bit (the sum taken in float64, where it
  is exact) on random W, on W from 1e-30 to 1e30 and at +-FLT_MAX, and each
  piece is a bf16 value (its fp32 form has its low 16 bits clear);
- the three piece x h products summed in float64 equal
  ``relgat_bwd_rel_bf16_plain`` (fp32 sums) within 1e-6 of the largest
  value, and JAX's ``precision=HIGHEST`` einsum of the same inputs (the
  TPU kernel's dattn dot, ``fused.py:649-656``, at that precision) to the
  same bar: each product piece x h is exact, so only sums differ;
- inf and NaN in W give inf and NaN in the same entries as the plain
  version (``hi`` carries them, ``mid = lo = 0``);
- ``design_of`` takes "mma" inside ``MMA_RANGES`` at widths a multiple of
  4 and "tile" elsewhere, ``with_design`` refuses CPU tensors (the
  wrapper runs the plain version on them) and ``rel_tiles`` sizes each
  design's partials.
The kernels against these on the card: ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu_torch.ops import cuda as kern

FLT_MAX = float(np.finfo(np.float32).max)


def _exact_sum(w):
    hi, mid, lo = kern.split_bf16x3(w)
    return hi.double() + mid.double() + lo.double(), (hi, mid, lo)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _inputs(heads, feat, num_rel, n, seed):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(
        rng.standard_normal((n, heads * feat)).astype(np.float32)
    ).to(torch.bfloat16)
    w = torch.from_numpy(
        (rng.standard_normal((n, heads, num_rel)) * 0.01).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((n, num_rel)).astype(np.float32))
    return h, w, b


def _piece_products(h, w):
    """The kernel's dattn in float64: the three bf16 piece x h products."""
    n, heads, _ = w.shape
    h3 = h.double().view(n, heads, -1)
    return sum(torch.einsum("nhr,nhf->hrf", p.double(), h3)
               for p in kern.split_bf16x3(w))


@pytest.mark.parametrize("scale", (1.0, 1e-3, 1e3))
@pytest.mark.parametrize("seed", (0, 1))
def test_split_is_exact_on_random_w(seed, scale):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(
        (rng.standard_normal((257, 16, 40)) * scale).astype(np.float32))
    total, pieces = _exact_sum(w)
    assert torch.equal(total, w.double())
    for p in pieces:
        assert p.dtype == torch.bfloat16
    # the pieces shrink by 2^8 or more each: hi holds W's top 8 bits
    hi, mid, lo = (p.double().abs() for p in pieces)
    assert bool((mid <= hi * 2.0 ** -7).all() and (lo <= mid * 2.0 ** -7).all())


def test_split_is_exact_from_1e_minus_30_to_1e30():
    rng = np.random.default_rng(2)
    mag = 10.0 ** rng.uniform(-30, 30, 200_000)
    sign = rng.choice((-1.0, 1.0), mag.size)
    w = torch.from_numpy((sign * mag).astype(np.float32))
    assert float(w.abs().min()) < 1e-29 and float(w.abs().max()) > 1e29
    total, _ = _exact_sum(w)
    assert torch.equal(total, w.double())


def test_split_keeps_flt_max_finite_and_exact():
    w = torch.tensor([FLT_MAX, -FLT_MAX, np.nextafter(np.float32(FLT_MAX),
                                                      np.float32(0)),
                      np.float32(1.1754944e-38), 0.0, -0.0],
                     dtype=torch.float32)
    total, pieces = _exact_sum(w)
    for p in pieces:
        assert bool(torch.isfinite(p).all())
    assert torch.equal(total, w.double())
    # truncation never rounds up: |hi| <= |W|, so FLT_MAX's hi is finite
    assert bool((pieces[0].double().abs() <= w.double().abs()).all())


@pytest.mark.parametrize("heads,feat,num_rel,n", [
    (16, 128, 40, 600), (12, 300, 40, 300), (3, 301, 7, 511), (1, 8, 7, 65),
    (4, 32, 1, 1),
])
def test_piece_products_equal_the_plain_version(heads, feat, num_rel, n):
    h, w, b = _inputs(heads, feat, num_rel, n, seed=heads * 1000 + feat)
    want, dbias = kern.relgat_bwd_rel_bf16_plain(h, w, b)
    got = _piece_products(h, w)
    assert _rel(got, want) <= 1e-6
    assert torch.equal(dbias, b.sum(0))


@pytest.mark.parametrize("heads,feat,num_rel,n", [
    (16, 128, 40, 600), (12, 300, 40, 300), (3, 301, 7, 511),
])
def test_piece_products_equal_jax_highest_dot(heads, feat, num_rel, n):
    h, w, _ = _inputs(heads, feat, num_rel, n, seed=7 + heads)
    h32 = h.float().numpy().reshape(n, heads, feat)
    want = jnp.einsum("nhr,nhf->hrf", jnp.asarray(w.numpy()),
                      jnp.asarray(h32), precision=jax.lax.Precision.HIGHEST)
    got = _piece_products(h, w)
    assert _rel(got, torch.from_numpy(np.array(want))) <= 1e-6


def test_nonfinite_w_spreads_as_in_the_plain_version():
    h, w, b = _inputs(3, 40, 7, 129, seed=5)
    w[5, 0, 1] = float("inf")
    w[7, 1, 2] = float("-inf")
    w[9, 2, 3] = float("nan")
    w[11, 0, 1] = float("-inf")  # with row 5: inf - inf where h agree
    w[13, 2, 4] = float("inf")
    # a NaN whose payload lies in the low 16 bits: truncation alone would
    # make it inf
    w[15, 1, 5] = torch.tensor(0x7F800001, dtype=torch.int32).view(
        torch.float32)
    h[13, 2 * 40 + 3] = 0.0  # inf x 0 is NaN
    hi, mid, lo = kern.split_bf16x3(w)
    bad = ~torch.isfinite(w)
    assert torch.equal(torch.isnan(hi), torch.isnan(w))
    assert torch.equal(torch.isinf(hi), torch.isinf(w))
    assert bool((mid[bad] == 0).all() and (lo[bad] == 0).all())
    want = kern.relgat_bwd_rel_bf16_plain(h, w, b)[0]
    got = _piece_products(h, w)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got[torch.isinf(got)], want[torch.isinf(want)].double())
    assert bool(torch.isnan(want).any() and torch.isinf(want).any())
    fin = torch.isfinite(want)
    assert _rel(got[fin], want[fin]) <= 1e-6


def test_split_refuses_other_types():
    with pytest.raises(ValueError, match="float32"):
        kern.split_bf16x3(torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("heads,feat,design", [
    (16, 128, "mma"), (12, 300, "mma"), (16, 200, "mma"), (12, 256, "mma"),
    (2, 1024, "mma"), (4, 32, "mma"), (3, 128, "mma"), (20, 136, "mma"),
    (3, 301, "tile"), (3, 302, "tile"), (1, 128, "tile"), (1, 8, "tile"),
    (4, 28, "tile"), (2, 1025, "tile"),
])
def test_bwd_rel_bf16_takes_the_design_of_its_width(heads, feat, design):
    """``relgat_bwd_rel_bf16`` takes the tensor cores where the card
    measured them faster than the tile kernel in both passes
    (``MMA_RANGES``: 32 to 1024 features, a multiple of 4, two heads or
    more) and the tile kernel elsewhere: at 3 x 301, where h is copied one
    value at a time, it measured slower, at 1 x 128 slower in one pass;
    widths under 32 were not timed. The other wrappers keep their
    designs."""
    assert kern.design_of(kern.relgat_bwd_rel_bf16, heads, feat) == design
    assert kern.designs_of(kern.relgat_bwd_rel_bf16) == ("tile", "mma")
    assert kern.designs_of(kern.relgat_fwd_bf16) == ("lanes", "ring", "pair")
    assert kern.design_of(kern.relgat_fwd, heads, feat) in ("lanes", "ring")


def test_the_model_widths_take_the_tensor_cores():
    for heads, feat in ((16, 128), (12, 300), (16, 200)):
        assert kern.design_of(kern.relgat_bwd_rel_bf16, heads, feat) == "mma"


def test_with_design_refuses_cpu_tensors():
    h, w, b = _inputs(2, 8, 3, 10, seed=0)
    with pytest.raises(ValueError, match="on the card only"):
        kern.with_design(kern.relgat_bwd_rel_bf16, "mma", h, w, b)
    before = kern.launch_counts()
    dattn, dbias = kern.relgat_bwd_rel_bf16(h, w, b)  # the plain version
    assert kern.launch_counts() == before
    want = kern.relgat_bwd_rel_bf16_plain(h, w, b)
    assert torch.equal(dattn, want[0]) and torch.equal(dbias, want[1])


@pytest.mark.parametrize("n,tile,mma", [
    (0, 0, 0), (1, 1, 1), (512, 1, 1), (513, 2, 2), (2049, 5, 5),
    (100_008, 196, 196),
])
def test_rel_tiles_size_each_designs_partials(n, tile, mma):
    """The tile design sums runs of 512 rows; the mma design's buffers hold
    runs of at least 512 rows (the kernel fills as many as suit the
    card)."""
    assert kern.rel_tiles("tile", n) == tile
    assert kern.rel_tiles("mma", n) == mma
