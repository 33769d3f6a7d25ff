"""The port's small modules against their JAX counterparts on the same
numpy inputs: segment ops, sampling, scorers, losses, metrics, schedules,
configuration. fp32 tolerance rtol 1e-5 / atol 1e-6 unless stated (sums
taken in another order)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu import config as jconfig
from relgat_projector_tpu import losses as jL
from relgat_projector_tpu import metrics as jM
from relgat_projector_tpu import schedules as jS
from relgat_projector_tpu.models import scorer as jsc
from relgat_projector_tpu.ops import segment as jseg
from relgat_projector_tpu_torch import config as tconfig
from relgat_projector_tpu_torch import losses as tL
from relgat_projector_tpu_torch import metrics as tM
from relgat_projector_tpu_torch import schedules as tS
from relgat_projector_tpu_torch.models import scorer as tsc
from relgat_projector_tpu_torch.ops import segment as tseg
from relgat_projector_tpu_torch.ops.sampling import sample_negative_dst

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _segments(seed=0, e=400, n=50, heads=3):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, n - 5, e))  # the last 5 segments are empty
    scores = rng.standard_normal((e, heads)).astype(np.float32)
    scores[ids == 3] = -np.inf  # one segment entirely masked
    return ids, scores, n


@pytest.mark.parametrize("op", ("segment_sum", "segment_max", "segment_softmax"))
def test_segment_ops_match_jax(op):
    ids, scores, n = _segments()
    if op == "segment_sum":
        scores = np.where(np.isfinite(scores), scores, 0.0).astype(np.float32)
    want = np.asarray(getattr(jseg, op)(jnp.asarray(scores), jnp.asarray(ids), n))
    got = getattr(tseg, op)(_t(scores), _t(ids), n).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if op == "segment_softmax":
        assert np.isfinite(got).all()


def test_negative_sampling_excludes_the_true_dst():
    gen = torch.Generator().manual_seed(0)
    dst = torch.arange(200) % 17
    neg = sample_negative_dst(gen, dst, num_nodes=17, num_neg=50)
    assert neg.shape == (200, 50)
    assert bool((neg != dst[:, None]).all())
    assert int(neg.min()) == 0 and int(neg.max()) == 16


def _vectors(seed=1, b=12, k=5, d=8):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, d)).astype(np.float32)
    s[0] = 0.0  # a zero row (a node without in-edges)
    dv = rng.standard_normal((b, d)).astype(np.float32)
    nv = rng.standard_normal((b, k, d)).astype(np.float32)
    rel = rng.integers(0, 4, b)
    emb = rng.standard_normal((4, d)).astype(np.float32)
    return s, dv, nv, rel, emb


@pytest.mark.parametrize("scorer", ("distmult", "transe"))
def test_scorers_and_their_gradients_match_jax(scorer):
    s, dv, _, rel, emb = _vectors()

    def jfn(s_, e_):
        sc = jsc.score_triplets({"rel_emb": e_}, scorer, s_, jnp.asarray(rel),
                                jnp.asarray(dv))
        tr = jsc.transform({"rel_emb": e_}, scorer, s_, jnp.asarray(rel))
        return jnp.sum(jnp.sin(sc)) + jnp.sum(jnp.cos(tr))

    want = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(s), jnp.asarray(emb))
    ts, te = _t(s).requires_grad_(True), _t(emb).requires_grad_(True)
    sc = tsc.score_triplets({"rel_emb": te}, scorer, ts, _t(rel), _t(dv))
    tr = tsc.transform({"rel_emb": te}, scorer, ts, _t(rel))
    (torch.sin(sc).sum() + torch.cos(tr).sum()).backward()
    for got, w in zip((ts.grad, te.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert float(ts.grad[0].abs().max()) < 1e3  # no 1/eps blow-up at zero


@pytest.mark.parametrize("self_adv", (False, True))
@pytest.mark.parametrize("masked", (False, True))
def test_multi_objective_loss_matches_jax(self_adv, masked):
    s, dv, nv, _, _ = _vectors(seed=2)
    rng = np.random.default_rng(3)
    pos = rng.standard_normal(12).astype(np.float32)
    neg = rng.standard_normal((12, 5)).astype(np.float32)
    w = (rng.random(12) > 0.3).astype(np.float32) if masked else None
    kw = dict(relgat_weight=1.0, pos_cosine_weight=0.5, neg_cosine_weight=1.0,
              mse_weight=0.25, use_self_adv_neg=self_adv, margin=1.0,
              self_adv_alpha=0.7)
    want = jL.multi_objective_loss(
        pos_score=jnp.asarray(pos), neg_score=jnp.asarray(neg),
        transformed_src=jnp.asarray(s), dst_vec=jnp.asarray(dv),
        neg_dst_vec=jnp.asarray(nv),
        weights=None if w is None else jnp.asarray(w), **kw)
    got = tL.multi_objective_loss(
        pos_score=_t(pos), neg_score=_t(neg), transformed_src=_t(s),
        dst_vec=_t(dv), neg_dst_vec=_t(nv),
        weights=None if w is None else _t(w), **kw)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(float(g), float(wv), **TOL)


def test_sanitize_and_metrics_match_jax():
    rng = np.random.default_rng(4)
    pos = rng.standard_normal(16).astype(np.float32)
    neg = rng.standard_normal((16, 6)).astype(np.float32)
    neg[0, 0] = pos[0]  # a tie counts against the positive
    pos[1], neg[2, 1], neg[3, 2] = np.nan, np.inf, -np.inf
    w = (rng.random(16) > 0.2).astype(np.float32)
    np.testing.assert_array_equal(
        tL.sanitize_scores(_t(neg)).numpy(),
        np.asarray(jL.sanitize_scores(jnp.asarray(neg))))
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else _t(weights)
        jm, jh = jM.compute_mrr_hits(jnp.asarray(pos), jnp.asarray(neg),
                                     (1, 3), weights=jw)
        tm, th = tM.compute_mrr_hits(_t(pos), _t(neg), (1, 3), weights=tw)
        np.testing.assert_allclose(float(tm), float(jm), **TOL)
        for k in (1, 3):
            np.testing.assert_allclose(float(th[k]), float(jh[k]), **TOL)


@pytest.mark.parametrize("kind", ("linear", "cosine", "constant"))
@pytest.mark.parametrize("decay", (1.0, 0.9))
def test_schedules_match_jax(kind, decay):
    assert tS.compute_total_and_warmup_steps(1000, 64, 3, None) == \
        jS.compute_total_and_warmup_steps(1000, 64, 3, None)
    js = jS.make_lr_schedule(1e-3, kind, 50, 5, decay)
    ts = tS.make_lr_schedule(1e-3, kind, 50, 5, decay)
    # atol 1e-6 of the base lr: fp32 cos(pi * p) near p = 1 cancels in
    # 1 + cos, where the two libraries' cos differ in the last bits.
    for step in (0, 1, 4, 5, 6, 30, 49, 50, 60):
        np.testing.assert_allclose(float(ts(torch.tensor(step, dtype=torch.int32))),
                                   float(js(step)), rtol=1e-5, atol=1e-9)


def test_config_fields_and_json_match_jax():
    for name in ("ModelConfig", "TrainConfig", "MeshConfig", "RunConfig"):
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jconfig, name))]
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tconfig, name))]
        assert jf == tf, name
    run = jconfig.RunConfig(
        model=jconfig.ModelConfig(in_dim=8, num_rel=3, use_pallas=True),
        train=jconfig.TrainConfig(lr=1e-3, eval_ks_ranks=(1, 5)))
    d = json.loads(run.to_json())
    d["model"]["a_future_field"] = 1
    port = tconfig.RunConfig.from_json(json.dumps(d))
    assert port.to_dict() == run.to_dict()


@pytest.mark.parametrize("field,value", [
    ("param_dtype", "float16"), ("param_dtype", "float64"),
    ("compute_dtype", "float16"), ("compute_dtype", "float64"),
])
def test_config_rejects_what_is_not_ported(field, value):
    with pytest.raises(NotImplementedError):
        tconfig.ModelConfig(in_dim=8, num_rel=3, **{field: value})
