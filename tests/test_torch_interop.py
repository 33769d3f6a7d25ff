"""The port's reference-format bridge against the JAX package's.

- ``import_torch_state_dict`` and ``export_torch_state_dict`` against JAX's
  on the same state dicts and weights: the same keys, every value bit for
  bit, the same ``ModelConfig`` fields; one and two GAT layers, heads of
  0, 1 and 2 projection layers, both scorers.
- ``save_pretrained`` writes the reference's flat ``relgat-model.pt``: the
  JAX importer reads a directory the port wrote, and the JAX model on it
  gives the port's representations within 1e-4 (the activation parity
  contract). A directory in the nested layout of earlier versions, and a
  JAX directory (``relgat-model.msgpack``), still load.
- Both interop CLIs on ``--device cpu`` write what JAX's write.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu import interop as jax_interop
from relgat_projector_tpu.config import ModelConfig as JaxModelConfig
from relgat_projector_tpu.data.graph import build_graph as jax_build_graph
from relgat_projector_tpu.models import model as jax_model
from relgat_projector_tpu_torch import interop
from relgat_projector_tpu_torch.config import ModelConfig
from relgat_projector_tpu_torch.data.graph import build_graph, pad_node_embeddings
from relgat_projector_tpu_torch.models import model as port_model
from relgat_projector_tpu_torch.utils.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-4, atol=1e-4)
N, E, R, D = 60, 300, 3, 12
# (GAT layers, projection layers (0: no head), scorer)
MODELS = [(1, 0, "distmult"), (1, 1, "transe"), (2, 1, "distmult"),
          (2, 2, "transe"), (1, 2, "distmult"), (2, 0, "transe"),
          (3, 3, "distmult")]


def _cfg(layers, proj, scorer, **kw):
    return {**dict(in_dim=D, num_rel=R, gat_out_dim=4, gat_heads=3,
                   gat_num_layers=layers, dropout=0.0,
                   project_to_input_size=proj > 0, projection_layers=proj,
                   scorer_type=scorer), **kw}


def _jax_params(layers, proj, scorer, seed=0, **kw):
    cfg = JaxModelConfig(**_cfg(layers, proj, scorer, **kw))
    return cfg, jax_model.init_model(jax.random.PRNGKey(seed), cfg)


def _bits(t):
    return t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy() \
        if t.dtype != torch.bool else t.numpy()


def assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


def _same_cfg(port_cfg, jax_cfg):
    want = jax_cfg.to_dict()
    got = {k: v for k, v in port_cfg.to_dict().items() if k in want}
    assert got == want


def _ids(m):
    return f"{m[0]}layer-proj{m[1]}-{m[2]}"


@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_export_state_dict_matches_jax(model):
    cfg, params = _jax_params(*model)
    emb = np.random.default_rng(1).standard_normal((N, D)).astype(np.float32)
    want = jax_interop.export_torch_state_dict(params, cfg, node_emb=emb)
    port_params = interop.params_from_jax(jax.device_get(params), "cpu")
    got = interop.export_torch_state_dict(port_params, node_emb=emb)
    assert_state_dicts_equal(got, want)
    if model[1] == 1:
        assert "projection.net.weight" in got
    if model[1] >= 2:
        assert "projection.net.2.bias" in got
    without = interop.export_torch_state_dict(port_params)
    assert "node_emb_fixed" not in without and len(without) == len(got) - 1


@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_import_state_dict_matches_jax(model):
    cfg, params = _jax_params(*model, seed=3)
    sd = jax_interop.export_torch_state_dict(
        params, cfg, node_emb=np.zeros((N, D), np.float32))
    want_params, want_cfg = jax_interop.import_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, scorer_type=model[2])
    got_params, got_cfg = interop.import_torch_state_dict(
        sd, scorer_type=model[2], device="cpu")
    _same_cfg(got_cfg, want_cfg)
    assert got_cfg.param_dtype == "float32"
    want_leaves = jax.tree_util.tree_leaves(want_params)
    assert len(tree_leaves(got_params)) == len(want_leaves)
    for g, w in zip(tree_leaves(got_params), want_leaves):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bf16_leaves_keep_their_type(tmp_path):
    """bf16 parameters export as bf16 tensors and import as bf16 with
    ``param_dtype="bfloat16"``, bit for bit, also through
    ``save_pretrained``; the reference directory widens them to float32."""
    cfg = ModelConfig(**_cfg(2, 2, "distmult", param_dtype="bfloat16"))
    params = port_model.init_model(cfg, seed=4, device="cpu")
    sd = interop.export_torch_state_dict(params)
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    back, back_cfg = interop.import_torch_state_dict(sd, device="cpu")
    assert back_cfg.param_dtype == "bfloat16"
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)

    port_model.save_pretrained(str(tmp_path / "port"), params, cfg)
    loaded, _ = port_model.load_from_pretrained(
        str(tmp_path / "port"), node_emb=np.zeros((0, D)), device="cpu")
    for a, b in zip(tree_leaves(loaded), tree_leaves(params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    interop.export_torch_checkpoint_dir(str(tmp_path / "port"),
                                        str(tmp_path / "ref"), device="cpu")
    ref = torch.load(tmp_path / "ref" / "relgat-model.pt", weights_only=True)
    assert sorted(ref) == sorted(sd)
    for k, v in ref.items():
        assert v.dtype == torch.float32 and torch.equal(v, sd[k].float())


def test_exported_tensors_own_their_storage(tmp_path):
    """A head's slice is saved alone, not with the whole ``[H, ...]``
    tensor it was cut from."""
    cfg = ModelConfig(**_cfg(2, 2, "distmult"))
    params = port_model.init_model(cfg, device="cpu")
    sd = interop.export_torch_state_dict(params)
    for v in sd.values():
        assert v.untyped_storage().nbytes() == v.numel() * v.element_size()


def _graph_and_emb():
    rng = np.random.default_rng(7)
    src, dst, et = rng.integers(0, N, E), rng.integers(0, N, E), \
        rng.integers(0, R, E)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    return src, dst, et, emb


def _port_repr(params, cfg, use_pallas=False):
    src, dst, et, emb = _graph_and_emb()
    g = build_graph(src, dst, et, N, num_rel=R, csr=use_pallas, device="cpu")
    x = torch.from_numpy(pad_node_embeddings(emb, g.num_nodes))
    cfg = ModelConfig.from_dict({**cfg.to_dict(), "use_pallas": use_pallas})
    return port_model.get_node_repr(params, cfg, x, g).numpy()


def _jax_repr(params, cfg):
    src, dst, et, emb = _graph_and_emb()
    g = jax_build_graph(src, dst, et, N)
    x = jnp.asarray(pad_node_embeddings(emb, g.num_nodes))
    return np.asarray(jax_model.get_node_repr(params, cfg, x, g))


@pytest.mark.parametrize("model", [(2, 2, "distmult"), (1, 1, "transe")],
                         ids=_ids)
def test_jax_reads_a_directory_the_port_saved(tmp_path, model):
    """The repaired ``save_pretrained``: ``relgat-model.pt`` holds the
    reference's flat keys, and JAX's importer serves it."""
    cfg = ModelConfig(**_cfg(*model))
    params = port_model.init_model(cfg, seed=5, device="cpu")
    port_dir = tmp_path / "port"
    port_model.save_pretrained(str(port_dir), params, cfg)
    saved = torch.load(port_dir / "relgat-model.pt", weights_only=True)
    assert all(isinstance(v, torch.Tensor) for v in saved.values())
    assert "scorer.rel_emb.weight" in saved
    (port_dir / "training-config.json").write_text(
        json.dumps({"scorer": model[2]}))
    jparams, jcfg = jax_interop.import_torch_checkpoint_dir(
        str(port_dir), str(tmp_path / "jax"))
    assert jcfg.scorer_type == model[2]
    np.testing.assert_allclose(_jax_repr(jparams, jcfg),
                               _port_repr(params, cfg, use_pallas=True), **TOL)


def test_nested_layout_of_earlier_versions_still_loads(tmp_path):
    cfg = ModelConfig(**_cfg(2, 2, "distmult"))
    params = port_model.init_model(cfg, seed=6, device="cpu")
    d = tmp_path / "old"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg.to_dict()))
    torch.save(tree_map(lambda t: t.clone(), params), d / "relgat-model.pt")
    back, back_cfg = port_model.load_from_pretrained(
        str(d), node_emb=np.zeros((1, D)), device="cpu")
    assert back_cfg == cfg
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_loads_a_jax_directory(tmp_path, param_dtype):
    """``config.json`` + ``relgat-model.msgpack`` from the JAX package's
    ``save_pretrained``: the same config and every leaf bit for bit."""
    jcfg, jparams = _jax_params(2, 2, "transe", seed=8,
                                param_dtype=param_dtype)
    jax_model.save_pretrained(str(tmp_path), jparams, jcfg)
    params, cfg = port_model.load_from_pretrained(
        str(tmp_path), node_emb=np.zeros((0, D)), device="cpu")
    assert set(json.loads((tmp_path / "config.json").read_text())) == set(
        cfg.to_dict())
    _same_cfg(cfg, jcfg)
    want = interop.params_from_jax(jax.device_get(jparams), "cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(want)):
        assert a.dtype == b.dtype == getattr(torch, param_dtype)
        assert torch.equal(a, b)


def test_load_refuses_weights_that_do_not_fit(tmp_path):
    cfg = ModelConfig(**_cfg(2, 2, "distmult"))
    port_model.save_pretrained(
        str(tmp_path), port_model.init_model(cfg, device="cpu"), cfg)
    other = ModelConfig(**_cfg(2, 2, "distmult", gat_heads=2))
    (tmp_path / "config.json").write_text(json.dumps(other.to_dict()))
    with pytest.raises(ValueError, match="do not fit"):
        port_model.load_from_pretrained(str(tmp_path), node_emb=np.zeros((1, D)),
                                        device="cpu")
    os.remove(tmp_path / "relgat-model.pt")
    with pytest.raises(FileNotFoundError, match="relgat-model.msgpack"):
        port_model.load_from_pretrained(str(tmp_path), node_emb=np.zeros((1, D)),
                                        device="cpu")


@pytest.mark.parametrize("source", ["port", "jax"])
def test_export_cli_matches_jax(tmp_path, source, capsys):
    """``main_export --device cpu`` on a port or a JAX directory writes the
    reference directory the JAX exporter writes from the same weights."""
    jcfg, jparams = _jax_params(2, 2, "transe", seed=9)
    jax_dir, ckpt = tmp_path / "jax", tmp_path / source
    jax_model.save_pretrained(str(jax_dir), jparams, jcfg,
                              add_files=[("relations-map.json", {"r0": 0})])
    if source == "port":
        cfg = ModelConfig(**_cfg(2, 2, "transe"))
        port_model.save_pretrained(
            str(ckpt), interop.params_from_jax(jax.device_get(jparams), "cpu"),
            cfg, add_files=[("relations-map.json", {"r0": 0})])
    interop.main_export(["--checkpoint", str(ckpt), "--out",
                         str(tmp_path / "ref"), "--device", "cpu"])
    assert "Exported" in capsys.readouterr().out
    jax_interop.export_torch_checkpoint_dir(str(jax_dir),
                                            str(tmp_path / "ref_jax"))
    for name in ("relgat-model.pt", "pytorch_model.bin"):
        assert_state_dicts_equal(
            torch.load(tmp_path / "ref" / name, weights_only=True),
            torch.load(tmp_path / "ref_jax" / name, weights_only=True))
    for name in ("config.json", "relations-map.json"):
        assert json.loads((tmp_path / "ref" / name).read_text()) == \
            json.loads((tmp_path / "ref_jax" / name).read_text())
    assert len(json.loads((tmp_path / "ref" / "config.json").read_text())) == 12


def test_import_cli_matches_jax(tmp_path, capsys):
    """``main --device cpu`` on a reference directory (and on the ``.pt``
    file itself) gives this package's directory with JAX's config fields
    and the same weights; the sidecars come across."""
    jcfg, jparams = _jax_params(1, 1, "transe", seed=10)
    ref = tmp_path / "ref"
    ref.mkdir()
    sd = jax_interop.export_torch_state_dict(jparams, jcfg)
    torch.save(sd, ref / "weights.pt")
    torch.save(sd, ref / "relgat-model.pt")
    (ref / "training-config.json").write_text(json.dumps({"scorer": "TransE"}))
    (ref / "relations-map.json").write_text(json.dumps({"r0": 0, "r1": 1}))
    want_params, want_cfg = jax_interop.import_torch_checkpoint_dir(
        str(ref), str(tmp_path / "jax"))
    for argv_ckpt, out in ((ref, "a"), (ref / "weights.pt", "b")):
        interop.main(["--checkpoint", str(argv_ckpt), "--out",
                      str(tmp_path / out), "--device", "cpu"])
        assert "Imported 1-layer/3-head model" in capsys.readouterr().out
        params, cfg = port_model.load_from_pretrained(
            str(tmp_path / out), node_emb=np.zeros((0, D)), device="cpu")
        _same_cfg(cfg, want_cfg)
        assert cfg.scorer_type == "transe"
        for g, w in zip(tree_leaves(params),
                        jax.tree_util.tree_leaves(want_params)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert json.loads(
            (tmp_path / out / "relations-map.json").read_text()) == {
                "r0": 0, "r1": 1}
