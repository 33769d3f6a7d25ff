"""The yardstick: the work a train step needs, from the shapes alone.

Counts are of what the algorithm needs, whatever implements it: each
input read once, each output written once, no scratch (partial rows,
per-(source row, relation) sums, split products) and no recomputation.
A roofline share is the least time those counts allow on the card (the
larger of operations over the operand type's peak and bytes over the
memory rate) over the time measured.

``peaks.json`` beside this file is the table of published peaks by the
name ``torch.cuda.get_device_name()`` gives; a card not in it has no
roofline and no utilisation, and the readers then report nothing.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"
WORD = 4  # bytes of fp32 and int32
_ROW_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def peaks_of(device_name: str) -> Optional[dict]:
    return json.loads(PEAKS_FILE.read_text()).get(device_name)


def operand_type(model: dict, which: str) -> str:
    """The operand type of the projections (``"gemm"``) or of the
    propagate's rows (``"propagate"``)."""
    if which == "gemm":
        return model.get("compute_dtype", "float32")
    return "bfloat16" if model.get("kernel_precision") == "default" \
        else "float32"


def gemm_shapes(model: dict, rows: int) -> List[Tuple[int, int, int, bool]]:
    """``(M, K, N, input_grad)`` of every product of a step: each GAT
    projection and projection-head linear over all ``rows`` node rows. The
    first GAT layer's input is the frozen embedding, so it takes no input
    gradient."""
    width = model["gat_heads"] * model["gat_out_dim"]
    in_dim = model["in_dim"]
    dims = [(in_dim, width)] + [(width, width)] * (model["gat_num_layers"] - 1)
    if model["project_to_input_size"]:
        k = int(model["projection_layers"])
        hidden = model.get("projection_hidden_dim") or width
        dims += ([(width, in_dim)] if k == 1 else
                 [(width, hidden)] + [(hidden, hidden)] * (k - 2)
                 + [(hidden, in_dim)])
    return [(rows, k, n, i > 0) for i, (k, n) in enumerate(dims)]


def gemm_work(m: int, k: int, n: int, input_grad: bool,
              operand_bytes: int) -> List[Tuple[float, float]]:
    """``(flops, bytes)`` of the forward product ``Y = X W`` (operands of
    ``operand_bytes``, an fp32 result), the weight gradient ``X^T G`` and,
    with ``input_grad``, ``G W^T``; a gradient product's operands and
    result are of the operand type."""
    ob, f = operand_bytes, 2.0 * m * k * n
    work = [(f, ob * (m * k + k * n) + WORD * m * n),
            (f, ob * (m * k + m * n + k * n))]
    if input_grad:
        work.append((f, ob * (m * n + k * n + m * k)))
    return work


def propagate_work(n_src: int, n_dst: int, edges: int, heads: int,
                   feat: int, num_rel: int, row_bytes: int,
                   ) -> Dict[str, Tuple[float, float]]:
    """``(flops, bytes)`` of the propagate's forward and of its whole
    backward, per layer and step.

    Forward: reads the source rows ``h`` (``row_bytes`` a value), the
    attention bank and relation biases, the dst-CSR (row pointers, each
    edge's source and relation); writes ``out`` [N, H*F] fp32 and the
    softmax statistics the backward needs (max and sum per row and head)
    and the bias sum per row. Operations: each edge's logit
    ``<h[src], attn[rel]>`` per head, or, where fewer, each (source row,
    relation)'s (2F either way), its weighted row (2F), six scalar
    operations per edge and head (LeakyReLU, shift, exp, sums) and the
    normalisation of ``out`` (one per value).

    Backward: reads ``h`` and the cotangent ``g`` (``row_bytes``), the
    bank, the statistics (max, sum, ``S = <out - bias, g>`` per row and
    head, ``g``'s sum per row) and the src-CSR; writes ``dh`` fp32 and the
    bank's and biases' gradients. Operations per edge and head: the
    weight's gradient ``<g[dst], h[src]>`` (2F) and the message's ``dh``
    term (2F), eight scalar operations, and the logit gradient's two
    products (into ``dh`` and into the bank, 2F each), per edge or, where
    fewer, per (source row, relation). The relation reduction is that one
    product, however it is computed."""
    hf = heads * feat
    logit_pairs = min(edges, n_src * num_rel)
    fwd_flops = (2.0 * feat * heads * logit_pairs
                 + edges * heads * (2.0 * feat + 6) + n_dst * hf)
    fwd_bytes = (row_bytes * n_src * hf
                 + WORD * (heads * num_rel * feat + num_rel + (n_dst + 1)
                           + 2 * edges + n_dst * hf + 2 * n_dst * heads
                           + n_dst))
    bwd_flops = (edges * heads * (4.0 * feat + 8)
                 + 2 * 2.0 * feat * heads * logit_pairs)
    bwd_bytes = (row_bytes * (n_src * hf + n_dst * hf)
                 + WORD * (heads * num_rel * feat + 3 * n_dst * heads + n_dst
                           + (n_src + 1) + 2 * edges + n_src * hf
                           + heads * num_rel * feat + num_rel))
    return {"forward": (fwd_flops, fwd_bytes),
            "backward": (bwd_flops, bwd_bytes)}


def least_seconds(flops: float, nbytes: float, flop_peak: float,
                  byte_peak: float) -> float:
    return max(flops / flop_peak, nbytes / byte_peak)


def step_counts(model: dict, rows: int, edges: int, num_rel: int,
                peaks: Optional[dict]) -> dict:
    """A step's model FLOPs and, on a card with known peaks, the least
    seconds of its products and of its propagate calls, and the peak the
    step's utilisation is taken against (the projections' operand type)."""
    gemm_type = operand_type(model, "gemm")
    row_type = operand_type(model, "propagate")
    gemms = [w for shape in gemm_shapes(model, rows)
             for w in gemm_work(*shape, _ROW_BYTES[gemm_type])]
    prop = propagate_work(rows, rows, edges, model["gat_heads"],
                          model["gat_out_dim"], num_rel, _ROW_BYTES[row_type])
    layers = model["gat_num_layers"]
    out = {
        "gemm_flop": sum(f for f, _ in gemms),
        "propagate_flop": layers * sum(f for f, _ in prop.values()),
    }
    out["model_flop"] = out["gemm_flop"] + out["propagate_flop"]
    if peaks is not None:
        rate, bw = peaks["flop_per_s"], peaks["bytes_per_s"]
        out["gemm_least_s"] = sum(least_seconds(f, b, rate[gemm_type], bw)
                                  for f, b in gemms)
        out["propagate_least_s"] = layers * sum(
            least_seconds(f, b, rate[row_type], bw) for f, b in prop.values())
        out["peak_flop_per_s"] = rate[gemm_type]
    return out
