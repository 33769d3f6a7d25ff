"""The port's export CLI against the JAX package's, on the same files.

A checkpoint written by the JAX package's ``save_pretrained`` (msgpack, no
training) and the same weights saved by the port's ``save_pretrained``; the
reference-format dataset files. JAX's ``export.main`` and the port's
``export.main --device cpu`` (the kernel route's plain versions) write
``repr.npy`` files that agree within 1e-4 and print the same top-k ids.
"""

import json
import pickle

import jax
import numpy as np
import pytest
import torch

from relgat_projector_tpu import export as jax_export
from relgat_projector_tpu.config import ModelConfig as JaxModelConfig
from relgat_projector_tpu.models import model as jax_model
from relgat_projector_tpu_torch import export
from relgat_projector_tpu_torch.config import ModelConfig
from relgat_projector_tpu_torch.data.synthetic import generate_synthetic_kg
from relgat_projector_tpu_torch.interop import params_from_jax
from relgat_projector_tpu_torch.models import model as port_model

TOL = dict(rtol=1e-4, atol=1e-5)
N, E, R, D = 150, 900, 4, 16
MODEL = dict(in_dim=D, num_rel=R, gat_out_dim=8, gat_heads=2,
             gat_num_layers=2, dropout=0.3, project_to_input_size=True,
             projection_layers=2, projection_dropout=0.3)


def _files(tmp_path):
    node2emb, rel2idx, triplets = generate_synthetic_kg(
        num_nodes=N, num_edges=E, num_rel=R, emb_dim=D, seed=3)
    # Node ids that are not 0..N-1, so the id compaction shows.
    node2emb = {7 * k + 2: v for k, v in node2emb.items()}
    triplets = [(7 * s + 2, 7 * d + 2, r) for s, d, r in triplets]
    paths = {k: str(tmp_path / name) for k, name in (
        ("nodes", "nodes.pkl"), ("rels", "rels.json"),
        ("triplets", "triplets.json"))}
    with open(paths["nodes"], "wb") as f:
        pickle.dump(node2emb, f)
    with open(paths["rels"], "w") as f:
        json.dump(rel2idx, f)
    with open(paths["triplets"], "w") as f:
        json.dump([[s, d, r] for s, d, r in triplets], f)
    return paths


def _argv(ckpt, paths, out):
    return ["--checkpoint", str(ckpt),
            "--nodes-embeddings-path", paths["nodes"],
            "--relations-mapping", paths["rels"],
            "--relations-triplets", paths["triplets"],
            "--out", str(out), "--query-node", "23",
            "--query-relation", "rel_2", "--top-k", "8"]


def _hits(printed):
    return json.loads(printed[printed.rindex('{\n  "query_node"'):])


@pytest.mark.parametrize("scorer", ["distmult", "transe"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_export_cli_matches_jax(tmp_path, capsys, writer, scorer):
    paths = _files(tmp_path)
    jcfg = JaxModelConfig(**MODEL, scorer_type=scorer)
    jparams = jax_model.init_model(jax.random.PRNGKey(4), jcfg)
    jax_dir = tmp_path / "jax_ckpt"
    jax_model.save_pretrained(str(jax_dir), jparams, jcfg)
    ckpt = jax_dir
    if writer == "port":
        ckpt = tmp_path / "port_ckpt"
        port_model.save_pretrained(
            str(ckpt), params_from_jax(jax.device_get(jparams), "cpu"),
            ModelConfig(**MODEL, scorer_type=scorer))
    capsys.readouterr()

    jax_export.main(_argv(jax_dir, paths, tmp_path / "jax.npy"))
    want = _hits(capsys.readouterr().out)
    export.main(_argv(ckpt, paths, tmp_path / "port.npy")
                + ["--device", "cpu"])
    printed = capsys.readouterr().out
    got = _hits(printed)

    assert f"node representations: ({N}, {D})" in printed
    got_repr, want_repr = (np.load(tmp_path / "port.npy"),
                           np.load(tmp_path / "jax.npy"))
    assert got_repr.dtype == np.float32 and got_repr.shape == (N, D)
    np.testing.assert_allclose(got_repr, want_repr, **TOL)
    assert got["query_node"] == want["query_node"] == 23
    assert got["relation"] == want["relation"] == "rel_2"
    scores = [h["score"] for h in want["top"]]
    assert np.diff(scores).max() < -1e-4  # no near-ties to break
    assert [h["node_id"] for h in got["top"]] == \
        [h["node_id"] for h in want["top"]]
    np.testing.assert_allclose([h["score"] for h in got["top"]], scores,
                               **TOL)


def test_export_cli_takes_a_relation_id_and_needs_a_device(tmp_path, capsys):
    paths = _files(tmp_path)
    cfg = ModelConfig(**MODEL)
    port_model.save_pretrained(str(tmp_path / "ckpt"),
                               port_model.init_model(cfg, device="cpu"), cfg)
    argv = _argv(tmp_path / "ckpt", paths, tmp_path / "r.npy")
    argv[argv.index("rel_2")] = "2"
    export.main(argv + ["--device", "cpu"])
    assert len(_hits(capsys.readouterr().out)["top"]) == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            export.main(argv)
