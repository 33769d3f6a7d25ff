"""Plain PyTorch reference of the RelGAT train step.

Independent of the program: it imports neither JAX nor the program, and
works everything out from what the benchmark made (the weights, the frozen
embeddings, the edges, the batches and their negatives, the dropout
stream's seed). It follows the published model (reference library
``core/model``, ``core/loss``, its torch Adam) and the precision the
configuration states:

- each GAT layer projects every node row, ``h = x W`` (``W`` the heads'
  ``[H, in, F]`` bank side by side), then per edge ``j -> i`` of relation
  ``r`` and head: logit ``LeakyReLU_0.2(<h_j, a_r>)``, a softmax over
  ``i``'s in-edges (denominator clamped at 1e-16), the weighted sum of the
  source rows, and the sum of the in-edges' relation biases added to every
  head and feature; output dropout on the concatenated heads; ELU between
  layers;
- the projection head (a bias-free linear, or linear -> exact GELU ->
  LayerNorm(1e-5) blocks then a linear) with dropout, DistMult scores, and
  the multi-objective loss (ranking: margin or self-adversarial; cosine to
  the destination and to the negatives; MSE) over the active weights;
- Adam (b1 0.9, b2 0.999, eps 1e-8, bias correction; ``adam`` folds L2
  weight decay into the gradient, ``adamw`` adds it after) at the
  library's linear schedule with warm-up.

The bf16 mode the configuration may state (``compute_dtype="bfloat16"``,
``kernel_precision="default"``) is the JAX package's contract, which the
program keeps: a projection's operands are rounded to bf16 and multiplied
into an fp32 sum (on the card by the tensor cores, as any bf16 product
there is, whose sums are not IEEE fp32 sums; summed in fp32 by other
means they flip bf16 roundings downstream), its backward
products take the cotangent rounded to bf16 and are rounded to bf16; the
propagate reads ``h`` rounded to bf16 (its
gradient passes straight through the rounding) and takes the message's
and the attention weight's gradients from ``g`` rounded to bf16, the
softmax's ``S`` and the bias gradient from the fp32 ``g``.

The propagate is a hand-written autograd function computed in blocks of
edges, so that no ``[E, H, F]`` array is whole (at 9.5M edges and 16 x
128 one fp32 such array is 78 GB). Attention dropout is not implemented
(both configurations run it at 0); ``run_steps`` refuses a rate above 0.

Memory grows with one layer's working set, not with the stack's: each GAT
layer keeps only its input (in bf16 where the next product rounds it to
bf16 anyway) and runs again in its backward (``torch.utils.checkpoint``);
the keep masks are kept as ``bool``; the head and the loss run on the
batch's distinct rows (the head is row-wise, so those rows' values are
the whole graph's), with the head's mask drawn for every row and indexed.

Every sum over edges is taken in a fixed order, so that two runs, and a
layer's run in its backward, give the same bits: ``Edges`` sorts the
edges by destination (the forward's sums) and by source and relation
(the backward's) once, and ``_sum_by`` sums each key's values in that
order (in pieces of at most ``SUM_PIECE``, then the pieces in order) and
adds the result to its row once.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS_SOFTMAX = 1e-16
EPS_NORM = 1e-12
SLOPE = 0.2
B1, B2, EPS_ADAM = 0.9, 0.999, 1e-8
SUM_PIECE = 256


def plain_precision() -> None:
    """fp32 products in fp32 throughout: no TF32, no reduced-precision
    sums of half-type products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype):
    """The product of two bf16 matrices summed in fp32, returned as
    ``out_dtype``: on the card the tensor cores' bf16 product (cuBLAS),
    elsewhere the product of the widened operands."""
    if a.is_cuda:
        if out_dtype == torch.float32:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a, b)
    return (a.float() @ b.float()).to(out_dtype)


class _Bf16Product(torch.autograd.Function):
    """``x @ w`` on bf16-rounded operands summed in fp32; the backward
    products take the bf16 cotangent and are rounded to bf16."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xq, wq)
        return _mm(xq, wq, torch.float32)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = g.to(torch.bfloat16)
        dx = (_mm(gq, wq.t(), torch.bfloat16).float()
              if ctx.needs_input_grad[0] else None)
        dw = (_mm(xq.t(), gq, torch.bfloat16).float()
              if ctx.needs_input_grad[1] else None)
        return dx, dw


def product(x: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    return _Bf16Product.apply(x, w) if bf16 else x @ w


class Edges:
    """The graph's real edges sorted by destination (stable), the
    permutation of that order that sorts them by source and relation, and
    the block size, in edges, of the propagate's edge loops."""

    def __init__(self, src, dst, etype, num_rel, block_edges):
        self.num_rel = int(num_rel)
        self.block = max(1, int(block_edges))
        order = torch.argsort(dst, stable=True)
        self.src, self.dst, self.etype = src[order], dst[order], etype[order]
        del order
        self.by_src = torch.argsort(self.src * self.num_rel + self.etype,
                                    stable=True)

    def blocks(self):
        e = int(self.src.shape[0])
        for s in range(0, e, self.block):
            yield slice(s, min(e, s + self.block))


def _sum_by(acc: torch.Tensor, keys: torch.Tensor, values: torch.Tensor):
    """``acc[k] += `` the sum of ``values`` whose key is ``k``, for
    ``keys`` sorted: each key's values summed in their order, in pieces of
    at most ``SUM_PIECE`` values one after another and then the pieces'
    sums one after another (segment reductions), and the sum added to its
    row once. No two threads add to one row, so the bits do not depend on
    the card's scheduling; the pieces keep a hub row's sum from running on
    a few threads alone."""
    rows, counts = torch.unique_consecutive(keys, return_counts=True)
    pieces = (counts + SUM_PIECE - 1) // SUM_PIECE
    if int(pieces.max()) > 1:
        lengths = torch.full((int(pieces.sum()),), SUM_PIECE,
                             dtype=counts.dtype, device=counts.device)
        lengths[pieces.cumsum(0) - 1] = counts - (pieces - 1) * SUM_PIECE
        values = torch.segment_reduce(values, "sum", lengths=lengths)
        counts = pieces
    acc.index_add_(0, rows, torch.segment_reduce(values, "sum",
                                                 lengths=counts))


class _Propagate(torch.autograd.Function):
    """``(h [N, H, F], attn [H, R, F], bias [R]) -> out [N, H, F]``."""

    @staticmethod
    def forward(ctx, h, attn, bias, edges: Edges, bf16: bool):
        n, heads, feat = h.shape
        src, dst, et = edges.src, edges.dst, edges.etype
        # The bf16 rows are kept as bf16; every product with an fp32
        # operand widens them exactly.
        rows = h.to(torch.bfloat16) if bf16 else h
        kw = dict(device=h.device, dtype=h.dtype)
        # <h_j, a_r> for every (source row, relation), then per edge.
        z = torch.einsum("nhf,hrf->nhr", rows.to(h.dtype), attn)[src, :, et]
        e = F.leaky_relu(z, SLOPE)
        z_pos = z >= 0
        del z
        m = torch.full((n, heads), -math.inf, **kw)
        m.scatter_reduce_(0, dst[:, None].expand_as(e), e, "amax")
        w = torch.exp(e - m[dst])
        del e, m
        l = torch.zeros((n, heads), **kw)
        _sum_by(l, dst, w)
        alpha = w / l.clamp_min(EPS_SOFTMAX)[dst]
        del w, l
        out = torch.zeros((n, heads, feat), **kw)
        for b in edges.blocks():
            _sum_by(out, dst[b], rows[src[b]] * alpha[b, :, None])
        bias_n = torch.zeros(n, **kw)
        _sum_by(bias_n, dst, bias[et])
        out += bias_n[:, None, None]
        ctx.save_for_backward(rows, attn, alpha, z_pos, out, bias_n)
        ctx.edges, ctx.bf16 = edges, bf16
        return out

    @staticmethod
    def backward(ctx, g):
        rows, attn, alpha, z_pos, out, bias_n = ctx.saved_tensors
        edges, bf16 = ctx.edges, ctx.bf16
        src, dst, et = edges.src, edges.dst, edges.etype
        n, heads, feat = out.shape
        r = edges.num_rel
        g = g.contiguous()
        s_dot = ((out - bias_n[:, None, None]) * g).sum(-1)   # [N, H]
        gsum = g.sum((1, 2))                                   # [N]
        gq = _bf16(g) if bf16 else g
        kw = dict(device=g.device, dtype=g.dtype)
        dh = torch.zeros((n, heads, feat), **kw)
        dz_sum = torch.zeros((n * r, heads), **kw)
        dbias_sr = torch.zeros(n * r, **kw)
        for b in edges.blocks():
            i = edges.by_src[b]
            s, d = src[i], dst[i]
            pair = s * r + et[i]
            gd, a = gq[d], alpha[i]
            dalpha = (gd * rows[s]).sum(-1)
            dz = a * (dalpha - s_dot[d])
            dz = torch.where(z_pos[i], dz, dz * SLOPE)
            _sum_by(dh, s, gd * a[..., None])
            del gd
            _sum_by(dz_sum, pair, dz)
            _sum_by(dbias_sr, pair, gsum[d])
        dz_sum = dz_sum.view(n, r, heads)
        dh += torch.einsum("nrh,hrf->nhf", dz_sum, attn)
        dattn = torch.einsum("nrh,nhf->hrf", dz_sum, rows.to(g.dtype))
        dbias = dbias_sr.view(n, r).sum(0)
        return dh, dattn, dbias, None, None


def _layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * scale + bias


def _l2n(x):
    sq = x.square().sum(-1, keepdim=True)
    out = x / torch.sqrt(sq.clamp_min(EPS_NORM * EPS_NORM))
    return torch.where(sq <= EPS_NORM * EPS_NORM, torch.zeros_like(x), out)


def _cosine_loss(pred, target):
    p = _l2n(pred)
    while p.dim() < target.dim():
        p = p.unsqueeze(1)
    return (1.0 - (p * _l2n(target)).sum(-1)).mean()


def _sanitize(s):
    return torch.where(torch.isnan(s), 0.0, s).clamp(-1e9, 1e9)


class _Rows(torch.autograd.Function):
    """``x[idx]``, whose backward sums each row's cotangents in a fixed
    order (``_sum_by``) where ``idx`` repeats a row."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        order = torch.argsort(idx, stable=True)
        dx = g.new_zeros((ctx.rows,) + tuple(g.shape[1:]))
        _sum_by(dx, idx[order], g[order])
        return dx, None


def _gat_layer(x, proj, attn, bias, keep, *, model: dict, edges: Edges,
               last: bool) -> torch.Tensor:
    """One GAT layer over every node row, with its output dropout's keep
    mask (or None) and, but for the last layer, the ELU. Where the next
    product rounds its operand to bf16, only that rounding is returned."""
    bf16_mm = model.get("compute_dtype", "float32") == "bfloat16"
    bf16_rows = model.get("kernel_precision") == "default"
    heads, feat = model["gat_heads"], model["gat_out_dim"]
    n = x.shape[0]
    w = proj.permute(1, 0, 2).reshape(proj.shape[1], heads * feat)
    h = product(x, w, bf16_mm).view(n, heads, feat)
    out = _Propagate.apply(h, attn, bias, edges,
                           bf16_rows).reshape(n, heads * feat)
    if keep is not None:
        out = out * keep / (1.0 - model["dropout"])
    if last:
        return out
    out = F.elu(out)
    return out.to(torch.bfloat16) if bf16_mm else out


def loss_of(p: Dict[str, torch.Tensor], model: dict, train: dict,
            node_emb: torch.Tensor, edges: Edges, batch, masks) -> torch.Tensor:
    """The loss of one triplet batch ``(src, rel, dst, neg)`` over the
    whole graph's representations, with the step's dropout keep masks
    (``draw_masks``). Each GAT layer keeps only its input and runs again
    in the backward; the head and the scores run on the batch's distinct
    rows."""
    layers = model["gat_num_layers"]
    masks = list(masks)
    keeps = ([masks.pop(0) for _ in range(layers)] if model["dropout"] > 0
             else [None] * layers)
    x = node_emb
    for li, keep in enumerate(keeps):
        attn = p[f"layers.{li}.attn"]
        bias = p.get(f"layers.{li}.rel_bias")
        if bias is None:
            bias = attn.new_zeros(edges.num_rel)
        layer = functools.partial(_gat_layer, model=model, edges=edges,
                                  last=li == layers - 1)
        x = checkpoint(layer, x, p[f"layers.{li}.proj"], attn, bias, keep,
                       use_reentrant=False, preserve_rng_state=False)
    src, rel, dst, neg = batch
    b = src.shape[0]
    ids, inv = torch.unique(torch.cat([src, dst, neg.reshape(-1)]),
                            return_inverse=True)
    x = x[ids]
    bf16_mm = model.get("compute_dtype", "float32") == "bfloat16"
    if model["project_to_input_size"]:
        k = int(model["projection_layers"])
        for i in range(k):
            x = product(x, p[f"projection.linears.{i}"], bf16_mm)
            if i < k - 1:
                x = F.gelu(x, approximate="none")
                x = _layer_norm(x, p[f"projection.ln_scale.{i}"],
                                p[f"projection.ln_bias.{i}"])
        if model["projection_dropout"] > 0:
            x = x * masks.pop(0)[ids] / (1.0 - model["projection_dropout"])
    picked = _Rows.apply(x, inv)
    return score_loss(model, train, picked[:b],
                      _Rows.apply(p["scorer.rel_emb"], rel),
                      picked[b:2 * b], picked[2 * b:].view(b, neg.shape[1], -1))


def score_loss(model: dict, train: dict, s, r, d, nd) -> torch.Tensor:
    """The batch's loss from its source, relation, destination and
    negative representations (``nd`` ``[B, K, D]``)."""
    pos = _sanitize((s * r * d).sum(-1))
    negs = _sanitize((s[:, None] * r[:, None] * nd).sum(-1))
    if train["use_self_adv_neg"]:
        adv = torch.softmax(train["self_adv_alpha"] * negs, dim=1).detach()
        rank = ((-F.logsigmoid(pos)).mean()
                + (-(adv * F.logsigmoid(-negs)).sum(1)).mean())
    else:
        rank = F.relu(train["margin"] + negs - pos[:, None]).mean()
    if not model["project_to_input_size"]:
        return rank
    t = s * r
    terms = [(train["relgat_weight"], rank),
             (train["pos_cosine_weight"], _cosine_loss(t, d)),
             (train["neg_cosine_weight"], 1.0 - _cosine_loss(t, nd)),
             (train["mse_weight"], (t - d).square().mean())]
    terms = [(wt, v) for wt, v in terms if wt != 0.0]
    return sum(wt * v for wt, v in terms) / sum(wt for wt, _ in terms)


def schedule(train: dict, num_examples: int):
    """The library's learning rate at an optimizer step: linear warm-up
    over ``warmup_ratio`` of ``epochs x ceil(examples / batch)`` steps,
    then linear to 0."""
    if train["lr_scheduler"] != "linear":
        raise ValueError("the reference implements the linear schedule")
    total = math.ceil(num_examples / train["train_batch_size"]) * max(
        1, int(train["epochs"]))
    warm = min(int(train["warmup_ratio"] * total), max(0, total - 1))

    def lr(step: int) -> float:
        if step < warm:
            return train["lr"] * step / max(1.0, warm)
        return train["lr"] * max(0.0, (total - step) / max(1.0, total - warm))

    return lr


def draw_masks(gen: torch.Generator, model: dict, rows: int, device):
    """A step's output-dropout keep masks in the order the model draws
    them (each GAT layer's, then the head's), each drawn as an fp32
    ``bernoulli_`` over every node row, as the program draws it, and kept
    as ``bool``."""
    shapes = []
    if model["dropout"] > 0:
        shapes += [((rows, model["gat_heads"] * model["gat_out_dim"]),
                    model["dropout"])] * model["gat_num_layers"]
    if model["project_to_input_size"] and model["projection_dropout"] > 0:
        shapes.append(((rows, model["in_dim"]), model["projection_dropout"]))
    return [torch.empty(s, device=device).bernoulli_(
        1.0 - rate, generator=gen).bool() for s, rate in shapes]


def run_steps(params: Dict[str, torch.Tensor], model: dict, train: dict,
              node_emb: torch.Tensor, edges: Edges, batches: List,
              num_examples: int, mask_gen: Optional[torch.Generator]) -> dict:
    """Train from ``params`` (fp32, not modified) on ``batches``, one
    ``(src, rel, dst, neg)`` each. Returns each step's loss, the first
    step's gradient as the optimizer takes it (with ``adam``'s L2 term),
    every parameter after the last step, and each leaf's raw first
    gradient norm."""
    if model.get("rel_attn_dropout", 0.0) > 0:
        raise NotImplementedError("the reference has no attention dropout")
    plain_precision()
    lr = schedule(train, num_examples)
    wd, kind = float(train["weight_decay"]), train["optimizer"]
    p = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad, raw_norms = [], None, None
    for count, batch in enumerate(batches):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        masks = (draw_masks(mask_gen, model, node_emb.shape[0],
                            node_emb.device) if mask_gen is not None else [])
        with torch.enable_grad():
            loss = loss_of(leaves, model, train, node_emb, edges, batch, masks)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        del masks
        losses.append(float(loss.detach()))
        grads = dict(zip(leaves, grads))
        p = {k: v.detach() for k, v in leaves.items()}
        if kind == "adam" and wd:
            eff = {k: grads[k] + wd * p[k] for k in p}
        else:
            eff = grads
        if first_grad is None:
            first_grad = {k: v.clone() for k, v in eff.items()}
            raw_norms = {k: float(v.norm()) for k, v in grads.items()}
        c = count + 1
        bc1, bc2 = 1 - B1 ** c, 1 - B2 ** c
        step_lr = lr(count)
        for k in p:
            mu[k] = (1 - B1) * eff[k] + B1 * mu[k]
            nu[k] = (1 - B2) * eff[k].square() + B2 * nu[k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS_ADAM)
            if kind == "adamw" and wd:
                u = u + wd * p[k]
            p[k] = p[k] - step_lr * u
    return {"losses": losses, "first_grad": first_grad, "params": p,
            "raw_grad_norms": raw_norms}
