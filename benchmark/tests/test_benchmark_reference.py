"""The plain reference: its hand-written propagate backward against
autograd through the naive formula, its train steps against the whole
stack composed naively and against the program's CPU path (this test
imports both; the reference imports neither the program nor JAX), its
keep masks, and its bits from run to run."""

import json

import pytest
import torch
import torch.nn.functional as F

from benchmark import generate, harness, judge
from benchmark.reference import model as ref

SEED = 2**32 + 99


def _naive(h, attn, bias, src, dst, et, n):
    """Every edge at once, autograd's own backward."""
    z = (h[src] * attn[:, et].transpose(0, 1)).sum(-1)
    e = F.leaky_relu(z, ref.SLOPE)
    m = torch.full((n, h.shape[1]), -torch.inf, dtype=h.dtype).scatter_reduce(
        0, dst[:, None].expand_as(e), e.detach(), "amax")
    w = torch.exp(e - m[dst])
    l = torch.zeros((n, h.shape[1]), dtype=h.dtype).index_add(0, dst, w)
    alpha = w / l[dst]
    out = torch.zeros_like(h).index_add(0, dst, h[src] * alpha[..., None])
    return out + torch.zeros(n, dtype=h.dtype).index_add(
        0, dst, bias[et])[:, None, None]


def test_propagate_backward_matches_autograd():
    gen = torch.Generator().manual_seed(3)
    n, e, heads, feat, rels = 40, 300, 3, 5, 4
    src = torch.randint(0, n, (e,), generator=gen)
    dst = torch.randint(0, n // 2, (e,), generator=gen)  # rows with no edges
    et = torch.randint(0, rels, (e,), generator=gen)
    h = torch.randn(n, heads, feat, generator=gen, dtype=torch.float64)
    attn = torch.randn(heads, rels, feat, generator=gen, dtype=torch.float64)
    bias = torch.randn(rels, generator=gen, dtype=torch.float64)
    g = torch.randn(n, heads, feat, generator=gen, dtype=torch.float64)
    leaves = [t.clone().requires_grad_(True) for t in (h, attn, bias)]
    want = torch.autograd.grad(_naive(*leaves, src, dst, et, n), leaves, g)
    edges = ref.Edges(src, dst, et, rels, block_edges=64)
    leaves = [t.clone().requires_grad_(True) for t in (h, attn, bias)]
    out = ref._Propagate.apply(*leaves, edges, False)
    assert torch.allclose(out, _naive(h, attn, bias, src, dst, et, n),
                          rtol=1e-12, atol=1e-12)
    got = torch.autograd.grad(out, leaves, g)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-10)


def _readings(cell):
    inputs = harness.make_inputs(cell, SEED, "cpu")
    reference = harness.reference_steps(cell, inputs, "cpu")
    record = harness.make_program(cell, inputs).checked_steps()
    return judge.readings(record, reference), record


def test_reference_follows_the_program_in_fp32(tiny):
    numbers, record = _readings(tiny("default-fp32.zipf-inv-10m"))
    assert all(record["finite"])
    # fp32 both sides, sums in other orders.
    assert numbers["loss_gap"] < 1e-6
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-3


def test_reference_follows_the_program_in_bf16(tiny):
    numbers, record = _readings(tiny("small-bf16.sparse-1m"))
    assert all(record["finite"])
    # The same bf16 roundings on both sides, flipped where an fp32 sum
    # taken in another order lands on a rounding boundary.
    assert numbers["loss_gap"] < 1e-4
    assert numbers["grad_gap_but_rel_bias"] < 1e-2
    assert numbers["rel_bias_gap"] < 1e-2
    assert numbers["grad_gap"] == max(numbers["grad_gap_but_rel_bias"],
                                      numbers["rel_bias_gap"])
    assert numbers["change_gap"] < 1e-2


# ---------------------------------------------------------------------------
# The rewritten composition (each layer run again in its backward, the head
# on the loss's rows, sums in a fixed order) against its naive twin
# ---------------------------------------------------------------------------

def _draw_masks_fp32(gen, model, rows, device):
    """The keep masks as the whole-stack composition drew them: fp32."""
    shapes = []
    if model["dropout"] > 0:
        shapes += [((rows, model["gat_heads"] * model["gat_out_dim"]),
                    model["dropout"])] * model["gat_num_layers"]
    if model["project_to_input_size"] and model["projection_dropout"] > 0:
        shapes.append(((rows, model["in_dim"]), model["projection_dropout"]))
    return [torch.empty(s, device=device).bernoulli_(1.0 - rate, generator=gen)
            for s, rate in shapes]


def _whole_stack_loss(p, model, train, node_emb, edges, batch, masks):
    """Every layer over every row, kept whole for autograd, then the head
    over every row and the batch's rows picked from it."""
    heads, feat = model["gat_heads"], model["gat_out_dim"]
    layers = model["gat_num_layers"]
    x, masks = node_emb, list(masks)
    n = x.shape[0]
    for li in range(layers):
        proj = p[f"layers.{li}.proj"]
        h = (x @ proj.permute(1, 0, 2).reshape(proj.shape[1], heads * feat))
        out = _naive(h.view(n, heads, feat), p[f"layers.{li}.attn"],
                     p[f"layers.{li}.rel_bias"], edges.src, edges.dst,
                     edges.etype, n).reshape(n, heads * feat)
        out = out * masks.pop(0) / (1.0 - model["dropout"])
        x = F.elu(out) if li < layers - 1 else out
    k = int(model["projection_layers"])
    for i in range(k):
        x = x @ p[f"projection.linears.{i}"]
        if i < k - 1:
            x = ref._layer_norm(F.gelu(x), p[f"projection.ln_scale.{i}"],
                                p[f"projection.ln_bias.{i}"])
    x = x * masks.pop(0) / (1.0 - model["projection_dropout"])
    src, rel, dst, neg = batch
    return ref.score_loss(model, train, x[src], p["scorer.rel_emb"][rel],
                          x[dst], x[neg])


def _float64_case():
    """Three layers of 2 x 4 and a 2-layer head in float64, dropout on, on
    40 node rows: rows 20-39 have no in-edges, rows 30-39 no out-edges,
    and rows 35-39 are in no batch."""
    cell = harness.load_cell("preset-large-bf16.zipf-inv-10m")
    model = dict(cell.config["model"], in_dim=6, gat_heads=2, gat_out_dim=4,
                 gat_num_layers=3, compute_dtype="float32",
                 kernel_precision="highest")
    train = dict(cell.config["train"], train_batch_size=4, num_neg=3)
    gen = torch.Generator().manual_seed(11)
    n, e, rels = 40, 400, 3
    src = torch.randint(0, 30, (e,), generator=gen)
    dst = torch.randint(0, 20, (e,), generator=gen)
    et = torch.randint(0, rels, (e,), generator=gen)
    weights = {k: v.double() for k, v in
               generate.make_weights(model, rels, 5, "cpu").items()}
    # Relation biases away from 0, so their sums are not all zeros.
    for li in range(3):
        weights[f"layers.{li}.rel_bias"].uniform_(-1, 1, generator=gen)
    emb = torch.randn(n, 6, generator=gen, dtype=torch.float64)
    batches = [(torch.randint(0, 35, (4,), generator=gen),
                torch.randint(0, rels, (4,), generator=gen),
                torch.randint(0, 35, (4,), generator=gen),
                torch.randint(0, 35, (4, 3), generator=gen))
               for _ in range(3)]
    edges = ref.Edges(src, dst, et, rels, block_edges=48)
    return model, train, weights, emb, edges, batches


def _run(case, seed=17):
    model, train, weights, emb, edges, batches = case
    return ref.run_steps(weights, model, train, emb, edges, batches, 400,
                         torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("piece", [ref.SUM_PIECE, 3])
def test_reference_matches_the_whole_stack_in_float64(piece, monkeypatch):
    """At the sums' own piece length, and at 3, where every row's sum runs
    in pieces."""
    case = _float64_case()
    monkeypatch.setattr(ref, "SUM_PIECE", piece)
    got = _run(case)
    monkeypatch.setattr(ref, "loss_of", _whole_stack_loss)
    monkeypatch.setattr(ref, "draw_masks", _draw_masks_fp32)
    want = _run(case)
    assert torch.allclose(torch.tensor(got["losses"]),
                          torch.tensor(want["losses"]), rtol=1e-12, atol=0)
    assert set(got["first_grad"]) == set(want["first_grad"])
    for key in ("first_grad", "params"):
        for k, v in want[key].items():
            assert v.dtype == torch.float64
            assert torch.allclose(got[key][k], v, rtol=1e-10,
                                  atol=1e-12 * float(v.abs().max())), (key, k)
    assert all(float(want["first_grad"][k].abs().max()) > 0
               for k in want["first_grad"])


def test_keep_masks_are_the_fp32_stream():
    """The masks kept as bool hold the fp32 draws' bits, and leave the
    generator where the fp32 draws leave it."""
    model = dict(harness.load_cell("small-bf16.sparse-1m").config["model"],
                 in_dim=5, gat_heads=2, gat_out_dim=3)
    a, b = (torch.Generator().manual_seed(2**33 + 7) for _ in range(2))
    got = ref.draw_masks(a, model, 50, "cpu")
    want = _draw_masks_fp32(b, model, 50, "cpu")
    assert [m.dtype for m in got] == [torch.bool] * 3
    assert all(torch.equal(g.to(w.dtype), w) for g, w in zip(got, want))
    assert torch.equal(a.get_state(), b.get_state())


def test_autograd_keeps_layer_inputs_and_masks_and_the_batch_rows(tiny):
    """Of the tensors with a row per node, the forward keeps only each
    layer's input (bf16 past the first, where the next product rounds it)
    and keep mask; the head and the loss keep only the batch's rows."""
    cell = tiny("preset-large-bf16.zipf-inv-10m")
    inputs = harness.make_inputs(cell, SEED, "cpu")
    model = cell.config["model"]
    rows = inputs["node_emb"].shape[0]
    width = model["gat_heads"] * model["gat_out_dim"]
    layers = model["gat_num_layers"]
    src, dst, et = (torch.from_numpy(a) for a in inputs["edges"])
    edges = ref.Edges(src, dst, et, inputs["num_rel"], 1000)
    gen = generate.device_generator(inputs["program_seed"] + 1, "cpu")
    masks = ref.draw_masks(gen, model, rows, "cpu")
    p = {k: v.clone().requires_grad_(True)
         for k, v in inputs["weights"].items()}
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append((tuple(t.shape), t.dtype)) or t,
            lambda t: t):
        loss = ref.loss_of(p, model, cell.config["train"],
                           inputs["node_emb"], edges,
                           inputs["batches"].at(0), masks)
    per_node = sorted((s for s in saved if s[0] and s[0][0] == rows), key=str)
    want = ([((rows, model["in_dim"]), torch.float32)]
            + [((rows, width), torch.bfloat16)] * (layers - 1)
            + [((rows, width), torch.bool)] * layers)
    assert per_node == sorted(want, key=str)
    torch.autograd.grad(loss, list(p.values()))


def _same_bits(a, b):
    assert a["losses"] == b["losses"]
    for key in ("first_grad", "params"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key]), key
    assert a["raw_grad_norms"] == b["raw_grad_norms"]


def _moderate_cell():
    """``preset-large-bf16`` at 4 layers of 4 x 32 on 3,000 nodes and
    60,000 base edges of ``zipf-inv-10m``'s rule: hub rows with thousands
    of edges, whose sums an unordered reduction would round differently
    from run to run."""
    cell = harness.load_cell("preset-large-bf16.zipf-inv-10m")
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["model"].update(in_dim=64, gat_heads=4, gat_out_dim=32)
    cell.traffic = dict(cell.traffic, num_nodes=3000, num_edges=60000)
    return cell


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda", marks=pytest.mark.gpu)])
def test_two_runs_give_the_same_bits(device, request):
    if device == "cuda":
        request.getfixturevalue("card")
    cell = _moderate_cell()
    inputs = harness.make_inputs(cell, SEED, device)
    first = harness.reference_steps(cell, inputs, device)
    _same_bits(first, harness.reference_steps(cell, inputs, device))
