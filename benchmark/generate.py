"""Inputs of one run, all made from the run's seed.

The graph is drawn on the host by one general generator that a traffic
file parameterises (``traffic/<name>.json``): ``num_nodes`` nodes,
``num_edges`` base edges over ``num_rel`` relations; sources
(``"src"``), destinations (``"dst"``) and relations (``"rel"``, uniform
where the file names none) are each drawn by a rule found by its name,
``rules/<rule>.py`` (``uniform`` or ``zipf``), in the order src, dst,
relation. With ``inverse`` every base edge ``(s, r, d)`` gains ``(d, r +
num_rel, s)``, which doubles the edges and the relations.

Everything else is made on the device from the seed, in a few large
calls: the frozen node embeddings, the model's weights, the triplet
batches (an epoch's permutation of the edges, so every batch's rows
differ) and their negatives (uniform over the other nodes). The program
receives only these arrays.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch


def derived_seeds(seed: int, count: int) -> List[int]:
    """``count`` independent 62-bit seeds from any non-negative ``seed``."""
    words = np.random.SeedSequence(int(seed)).generate_state(count, np.uint64)
    return [int(w) >> 2 for w in words]


RULES_DIR = Path(__file__).resolve().parent / "rules"
UNIFORM = {"rule": "uniform"}


def _draw(rng: np.random.Generator, rule: dict, n: int, e: int) -> np.ndarray:
    """``e`` ids below ``n`` by ``rules/<rule>.py``'s ``draw``."""
    path = RULES_DIR / f"{rule['rule']}.py"
    if not path.is_file():
        raise ValueError(f"unknown rule {rule['rule']!r}: no {path}")
    spec = importlib.util.spec_from_file_location(
        f"_rule_{rule['rule']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return np.asarray(mod.draw(rng, rule, n, e))


def make_graph(traffic: dict, seed: int) -> Tuple[np.ndarray, ...]:
    """``(src, dst, etype, num_nodes, num_rel)``, int64 arrays."""
    n, e, r = (int(traffic[k]) for k in ("num_nodes", "num_edges", "num_rel"))
    rng = np.random.default_rng(seed)
    src = _draw(rng, traffic["src"], n, e)
    dst = _draw(rng, traffic["dst"], n, e)
    et = _draw(rng, traffic.get("rel", UNIFORM), r, e)
    if traffic.get("inverse", False):
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        et = np.concatenate([et, et + r])
        r *= 2
    return (src.astype(np.int64), dst.astype(np.int64), et.astype(np.int64),
            n, r)


def padded_nodes(num_nodes: int) -> int:
    """The node rows the program computes on: ``N + 1`` rounded up to 8
    (its padding, inherited from the JAX package's COO layout)."""
    return -(-(num_nodes + 1) // 8) * 8


def device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def make_embeddings(num_nodes: int, in_dim: int, seed: int,
                    device) -> torch.Tensor:
    """Frozen ``[N_pad, in_dim]`` fp32 embeddings, N(0, 1), padded rows 0."""
    emb = torch.zeros((padded_nodes(num_nodes), in_dim), device=device)
    emb[:num_nodes].normal_(generator=device_generator(seed, device))
    return emb


def leaf_specs(model: dict, num_rel: int) -> List[Tuple[str, tuple, str, float]]:
    """``(name, shape, init, bound)`` of every parameter, as the library
    initialises them: ``uniform`` leaves U(-bound, bound) (xavier for the
    projections' and attention's banks and the relation embeddings, torch
    ``nn.Linear``'s default for the head), ``zeros`` and ``ones``."""
    heads, feat = model["gat_heads"], model["gat_out_dim"]
    width, in_dim = heads * feat, model["in_dim"]
    specs = []
    d_in = in_dim
    for li in range(model["gat_num_layers"]):
        specs.append((f"layers.{li}.proj", (heads, d_in, feat), "uniform",
                      math.sqrt(6.0 / (d_in + feat))))
        specs.append((f"layers.{li}.attn", (heads, num_rel, feat), "uniform",
                      math.sqrt(6.0 / (feat + num_rel))))
        if model.get("use_rel_bias", True):
            specs.append((f"layers.{li}.rel_bias", (num_rel,), "zeros", 0.0))
        d_in = width
    scorer_dim = width
    if model["project_to_input_size"]:
        k = int(model["projection_layers"])
        hidden = model.get("projection_hidden_dim") or width
        dims = ([(width, in_dim)] if k == 1 else
                [(width, hidden)] + [(hidden, hidden)] * (k - 2)
                + [(hidden, in_dim)])
        for i, (a, b) in enumerate(dims):
            specs.append((f"projection.linears.{i}", (a, b), "uniform",
                          1.0 / math.sqrt(a)))
        for i in range(k - 1):
            specs.append((f"projection.ln_scale.{i}", (hidden,), "ones", 0.0))
            specs.append((f"projection.ln_bias.{i}", (hidden,), "zeros", 0.0))
        scorer_dim = in_dim
    specs.append(("scorer.rel_emb", (num_rel, scorer_dim), "uniform",
                  math.sqrt(6.0 / (scorer_dim + num_rel))))
    return specs


def make_weights(model: dict, num_rel: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every parameter, fp32 on the device, from one uniform draw."""
    specs = leaf_specs(model, num_rel)
    sizes = [math.prod(s) if init == "uniform" else 0
             for _, s, init, _ in specs]
    buf = torch.empty(sum(sizes), device=device).uniform_(
        -1.0, 1.0, generator=device_generator(seed, device))
    out, at = {}, 0
    for (name, shape, init, bound), size in zip(specs, sizes):
        if init == "uniform":
            out[name] = (buf[at:at + size] * bound).view(shape)
            at += size
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


@dataclasses.dataclass
class Batches:
    """``steps`` triplet batches ``[S, B]`` and negatives ``[S, B, K]``."""

    src: torch.Tensor
    rel: torch.Tensor
    dst: torch.Tensor
    neg: torch.Tensor

    @property
    def steps(self) -> int:
        return int(self.src.shape[0])

    def at(self, i: int):
        i %= self.steps
        return self.src[i], self.rel[i], self.dst[i], self.neg[i]


def make_batches(src: np.ndarray, dst: np.ndarray, etype: np.ndarray,
                 num_nodes: int, batch: int, num_neg: int, steps: int,
                 seed: int, device) -> Batches:
    """The first ``steps`` batches of an epoch over the edges (fewer if
    the epoch is shorter), each edge a triplet, with ``num_neg`` negative
    destinations a row drawn uniformly from the nodes other than the true
    destination."""
    gen = device_generator(seed, device)
    e = int(src.shape[0])
    steps = max(1, min(int(steps), e // batch))
    picks = torch.randperm(e, generator=gen, device=device)[:steps * batch]
    picks = picks.view(steps, batch)
    as_t = {k: torch.from_numpy(a).to(device)
            for k, a in (("src", src), ("dst", dst), ("rel", etype))}
    d = as_t["dst"][picks]
    c = torch.randint(0, num_nodes - 1, (steps, batch, num_neg),
                      generator=gen, device=device)
    neg = c + (c >= d[..., None]).to(c.dtype)
    return Batches(src=as_t["src"][picks], rel=as_t["rel"][picks], dst=d,
                   neg=neg)
