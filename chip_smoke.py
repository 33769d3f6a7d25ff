#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (relgat_projector_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--out DIR]

Phases, in order; any failure exits non-zero:

1. device   - fails without a CUDA card; prints nvidia-smi's name and limit.
2. build    - builds every kernel from csrc/ with nvcc; prints ptxas' report.
3. parity   - each kernel, fp32 and bf16 variant, against its plain
              PyTorch version on the card, at H=16, F=128, R=40 on a
              20k-node / 200k-edge graph with rows without in-edges, rows of
              degree 2,500, one row of 50,000 in-edges (split by the
              forward's work plan), self-loops and multi-edges; attention
              dropout 0.0 and 0.3, with and without rel_bias. Max relative
              error (max|a-b| / max|b|) <= 1e-5 against the plain version
              run in float64 on the same inputs (for the bf16 variants the
              same bf16 values, widened exactly).
   parity_wide - the same for every kernel at (H, F) = (12, 300) (the
              library's default), (4, 512), (2, 1024), (3, 301), (16, 128),
              (3, 128) and (1, 128) (odd head counts: the bf16 pair
              kernels' unpaired last head), on a 4,000-node graph whose
              rows have exactly 0, 1,
              2 and 3 in- and out-edges, self-loops, a repeated triple and
              a row of 1,000 in-edges that the forward splits.
   agree    - one training forward and backward of a small model through
              the kernels and through the plain path on the card, with the
              same weights, negatives and dropout draws: loss and every
              gradient within 1e-4 relative.
   agree_bf16 - the same model with kernel_precision="default" (fp32
              compute): through the bf16 kernels on the card against the
              same route on a CPU copy (plain versions), within 1e-2 (bf16
              precision: the fp32 bits of the two devices differ, and
              rounding to bf16 turns some of those differences into a bf16
              step); and the bf16 kernels against the fp32 kernels,
              printed, and on the JAX bf16 envelope's own inputs (scripts/
              tpu_kernel_check.py's) within 1.25x that envelope.
4. train    - the production model (training_scripts/
              run-relgat-trainer-base-model.sh: in_dim 1152, 40 relations,
              2 GAT layers of 16 heads x 128, projection back to the input
              with 2 layers, distmult, batch 128, 32 negatives,
              self-adversarial, loss weights 1/1/1/0, dropout 0.3, weight
              decay 1e-4, lr 2e-5 linear) on a seeded uniform graph of
              100,000 nodes and 1,000,000 edges (bench.py's scale), random
              weights from a seed: 3 warm-up and 10 timed steps through the
              kernels. Each kernel's launch count must equal layers x steps.
              Then torch.profiler over two more steps: device time by
              kernel group and the device's idle share (diagnostic).
   train_bf16 - the same model, graph, weights and batches in the bf16
              mode (kernel_precision="default", compute_dtype="bfloat16"):
              each bf16 kernel launches layers x steps times and the fp32
              ones never; the first step's loss within 1e-2 relative of the
              fp32 first step's; step time, peak memory and the profile.
   train_default_width - the library's default widths (12 heads x 300,
              one GAT layer) on the same graph, embeddings and batches, 4
              steps in fp32 and 4 in bf16: each kernel of the variant
              launched layers x steps times.
   remat    - TRAIN with remat on and off, 3 steps each in fp32 and in the
              bf16 mode, TRAIN's dropout and an attention dropout of 0.2:
              the parameters equal (bit for bit expected, 1e-6 at most),
              the peak memory lower with remat, and relgat_fwd launched
              twice a layer a step under remat (the recompute).
   param_bf16 - TRAIN with param_dtype="bfloat16" in the bf16 mode for 4
              steps: every parameter and Adam moment bf16, each bf16 kernel
              launched layers x steps times, a finite loss; the AGREE model
              with bf16 parameters through the kernels on the card against
              the same route on a CPU copy within 1e-2; step time and peak
              memory beside train_bf16's.
   train_fp16 - TRAIN with compute_dtype="float16" (fp32 parameters) for 3
              steps on the train phase's graph, embeddings and batches:
              the projections take fp16 operands with an fp32 product, so
              each fp32 kernel launches layers x steps times and the bf16
              ones never; the first step's loss within 1e-2 relative of
              the fp32 first step's; step time and peak memory.
   param_fp16 - the AGREE model with param_dtype="float16", 3 Adam steps
              through the kernels on the card and on a CPU copy: each
              step's finite flag and count of non-finite scores equal (the
              JAX package's fp16 Adam goes non-finite, and the port takes
              the same steps), finite losses within 1e-2.
   edges_8m - TRAIN's model on a seeded uniform graph of 100,000 nodes and
              8,000,000 edges (the size the JAX package's scanned propagate
              was made for), in fp32 and bf16: 3 steps with
              scan_segments=4 give the same bits as without (the kernels
              run unsegmented); the steps' peak memory against the same
              steps on the 1M-edge graph grows per edge by no more than
              the graph layout's reckoning + 10% and 64 bytes; step time,
              edge-messages/s and each kernel's time at 8M edges.
5. export   - one forward-only get_node_repr at the same size.
   serve    - the train phase's model and graph served: a reference round
              trip (save_pretrained -> export_torch_checkpoint_dir ->
              import_torch_checkpoint_dir -> load_from_pretrained, on the
              card) and the bf16 mode loaded from its own directory, each
              exported 3 times through the kernels: the same bits as
              get_node_repr on the live parameters, relgat_fwd (or
              relgat_fwd_bf16) once per layer per export and no other
              kernel; then query_expansion for 128 queries, top-10 over the
              100,000 rows: scores within 1e-5 of a float64 recomputation
              on the same representations, ids equal wherever the float64
              scores are not tied within 1e-6.
6. kernels  - each kernel, fp32 and bf16 variant, held to its plain version
              and timed with CUDA events at the train phase's shapes and at
              the default widths (launches from train_default_width), the
              bf16 forward and src pass giving the same bits twice, beside
              its bound on this card (bf16 rows counted at 2 bytes) and, for
              relgat_bwd_rel, one torch.einsum on the same inputs; then each
              variant's backward pair against the bound of the whole TPU
              backward kernel's function, and the rates of a plain copy, a
              row gather and a sparse product (torch.sparse.mm of the
              dst-CSR against h) on this card.
7. zipf     - the same size with in-degree on hubs (dst drawn with
              p ~ 1/rank, bench.py's zipf class; the heaviest row has ~83k
              in-edges): 3 warm-up and 5 timed train steps, and relgat_fwd
              timed on that graph and held to its float64 plain version on
              the in-edges of the 16 heaviest and 1,024 random rows; then,
              a diagnostic without a bar, relgat_bwd_src_bf16 on that graph
              with src and dst swapped (out-degree hubs).
8. trainer  - the port's CLI (cli.main, in process) on the card with the
              production script's flags (preset small, 16 heads x 128, 2
              GAT layers, projection to the input with 2 layers, distmult,
              batch 128, 32 negatives, self-adversarial, loss weights
              1/1/1/0, dropout 0.3, weight decay 1e-4, lr 2e-5 linear,
              early-stop patience 10, --use-pallas) on a synthetic KG of
              in_dim 1152 and 40 relations (seed 0). Leg 1 trains one epoch
              with eval and best-checkpoint saves; leg 2 is the same argv
              with --resume; leg 3 is leg 1's argv with --compute-dtype
              bfloat16 --kernel-precision default in a fresh directory.
              Checked: the checkpoint layout and pruning, the saved step
              counts, each kernel's launches (one forward per layer per
              step and per eval, one of each backward kernel per layer per
              step; the bf16 variants in leg 3, the fp32 kernels in legs 1
              and 2), that leg 2 resumed from leg 1's final directory, a
              finite last loss, and both bf16 fields in leg 3's
              training-config.json. Between legs 1 and 2 the export CLI
              (export.main --device cuda) serves leg 1's final directory
              over the same synthetic KG written as the reference's three
              files: its repr.npy equals get_node_repr on that directory's
              train-state parameters bit for bit, relgat_fwd runs once per
              layer and no other kernel, and it prints 10 hits. Leg 4 is
              leg 1's argv with --steps-per-call 8 (176 steps, 22 calls) in a fresh
              directory: its final parameters equal leg 1's (bit for bit
              expected, 1e-6 at most), it logs and evaluates only at the
              windows of 100 dispatched steps, and logs
              train/edges_per_sec. Then through the Python API: one step
              after maybe_resume is bit-identical to the step from the live
              state, and the trainer's epoch per step is within 1.10x of a
              bare make_train_step loop over the same batches. Cuts, against
              production: the graph is 20,000 nodes and 25,000 triplets
              (the generator's nn-pool 256), not plWordNet's size; one epoch
              per leg, not 60; eval and save every 100 steps, not 500, so
              that they fire within the epoch's 176 steps.
9. halo     - several devices on the one card: the ranks are processes of
              this script (--rank-mode), joined on gloo, named explicitly
              (NCCL refuses two ranks on one device; gloo takes no CUDA
              tensor, so every collective goes through host memory).
              TRAIN's model and graph, dropout off, lr 2e-5 constant, 2
              steps on each grid (data, graph) = (1, 2), (1, 4), (2, 2),
              each a process group of its own, in fp32 and the bf16 mode,
              against the same steps on one device through the kernels:
              the first step's gradient leaf by leaf (||a-b|| / ||b||
              over each leaf, as the optimizer receives it; max|a-b| /
              max|b| reported), each step's loss and grad norm within 1e-4
              (fp32) and 1e-2 (bf16); every rank of a grid with the same
              parameters; the parameters after the steps leaf by leaf,
              reported with the gradients and updates at the worst
              element; each rank launching each
              kernel of the mode 2 x layers x steps times (the local and
              the remote subset) and no other. Then the split kernels on
              shard 0 of the G = 4 plan (the local subset over the shard's
              own rows, the remote one over the halo buffer: source rows
              apart from the destination rows, canonical edge ids),
              attention dropout 0.2, fp32 and bf16: each within 1e-5 of
              its float64 plain version, the forward and src pass the same
              bits twice, timed beside their bounds (rows of the kernels
              line). A clustered graph (TRAIN's size, 8 clusters, 90% of
              the edges inside them, ids at random) gives halo_pair and
              the bytes sent a layer at G = 4 with and without the
              partitioner, on its native (C++, built here with g++) route,
              which must load, and on its NumPy route: each route's
              seconds and halo_pair, and the native edge cut within the
              JAX package's bar, 1.3 x the NumPy route's + 0.02. Last,
              cli.main on two ranks with --mesh-graph 2 --partition-nodes
              on TRAINER's KG (batch 4096 with 8 negatives, one epoch of 6
              steps, then --resume), rank 1 on the partitioner's NumPy
              route (RELGAT_NO_NATIVE=1): both ranks log rank 0's edge
              cut, rank 0 loads the native library and rank 1 does not;
              only
              rank 0 writes, the state a trainer resumes from the final
              checkpoint equals the CLI trainer's and one step from each
              gives the same bits, the launches are one forward a layer a
              step and per eval and one backward a layer a step, both
              subsets. One "halo" line: step ms and peak memory per rank
              (time-sharing, not a scaling number), halo_pair, exchange
              bytes, the errors.
   grid_routes - the rest of the multi-device modes, the same way (3
              steps, lr 2e-5 constant, each grid (data, graph, model) a
              process group of its own, against the one-device run of the
              same mode at the same bars): head tensor parallelism on the
              halo route at (1, 1, 2), (1, 2, 2) (fp32 and bf16) and
              (2, 2, 2); the replicated route at (1, 2, 1) (fp32, bf16, and
              fp32 with TRAIN's dropout and an attention dropout of 0.2,
              whose masks are one device's) and (2, 2, 1); the gspmd route
              (plain, as in JAX) at (1, 2, 1) on phase 3's 20k-node graph.
              Every rank the same parameters; each kernel of the mode
              launched 2 x layers x steps times a rank on the halo route,
              layers x steps on the replicated route, never on gspmd.
              Then cli.main on two ranks for one epoch with --mesh-model 2,
              and again with --mesh-propagate replicated --mesh-graph 2
              (only rank 0 writes; the launches as in the halo CLI leg,
              one subset on the replicated route). Rows of the kernels
              line: a head-TP tile (8 heads, G = 2) and shard 0 of the
              replicated plan at G = 4 (sources: every row). A
              "grid_routes" line (step ms, peak, edges, the halo and join
              bytes a rank sends a layer, the errors) and a
              "grid_routes_cli" line.

The last lines are the kernels JSON line, nvidia-smi's name and power limit,
and {"ok": true, "device": {...}}; a "single_device_settings" line gives the
seconds the remat, param_bf16, train_fp16, param_fp16 and edges_8m phases
took, and a "serve" line
(after phase 8) the serve phase's and the export CLI's times and launches.
The profiles go through the package's utils.profiling.trace. The timing runs --kernels-only
(phase 6 alone, launches null) and --zipf-only (phase 7 alone) end with
{"timing_only": true, "device": {...}} instead. With --out DIR the result
lines, profiler traces of two train steps (a directory each) and the
trainer's console logs are also written there (its checkpoints go to a
temporary directory, removed after).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import itertools
import json
import os
import pickle
import re
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from relgat_projector_tpu_torch import cli
from relgat_projector_tpu_torch import export as export_cli
from relgat_projector_tpu_torch.config import ModelConfig, TrainConfig
from relgat_projector_tpu_torch.data.dataset import RelGATData
from relgat_projector_tpu_torch.data.native import load_native
from relgat_projector_tpu_torch.data.partition import (
    edge_cut_fraction,
    partition_node_permutation,
)
from relgat_projector_tpu_torch.data.graph import (
    build_graph,
    pad_node_embeddings,
)
from relgat_projector_tpu_torch.data.synthetic import generate_synthetic_kg
from relgat_projector_tpu_torch.inference import (
    export_node_representations,
    query_expansion,
)
from relgat_projector_tpu_torch.interop import (
    export_torch_checkpoint_dir,
    import_torch_checkpoint_dir,
)
from relgat_projector_tpu_torch.models.model import (
    get_node_repr,
    init_model,
    load_from_pretrained,
    save_pretrained,
    transform_from_vectors,
)
from relgat_projector_tpu_torch.models.scorer import l2_normalize
from relgat_projector_tpu_torch.ops import cuda as kern
from relgat_projector_tpu_torch.ops import propagate
from relgat_projector_tpu_torch.ops.cuda.build import build_all
from relgat_projector_tpu_torch.ops.propagate import relgat_propagate_kernels
from relgat_projector_tpu_torch.parallel.halo import (
    build_halo_graph,
    halo_rows_per_shard,
    shard_edges,
)
from relgat_projector_tpu_torch.parallel.pallas_sharded import (
    shard_csr_layout,
)
from relgat_projector_tpu_torch.schedules import (
    compute_total_and_warmup_steps,
    make_lr_schedule,
)
from relgat_projector_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from relgat_projector_tpu_torch.train.step import (
    loss_and_grads,
    make_train_step,
)
from relgat_projector_tpu_torch.train.trainer import RelGATTrainer
from relgat_projector_tpu_torch.utils.profiling import trace
from relgat_projector_tpu_torch.utils.rng import RngStreams
from relgat_projector_tpu_torch.utils.tree import tree_leaves, tree_map

# H100 SXM: HBM rate and fp32 rate outside the tensor cores (NVIDIA's data
# sheet, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
REL_TOL = 1e-5
SEED = 0
DEVICE = "cuda"
PARITY = dict(num_nodes=20_000, num_edges=200_000, num_rel=40, heads=16,
              feat=128, heavy_rows=4, heavy_degree=2_500, hub_degree=50_000)
TRAIN = dict(num_nodes=100_000, num_edges=1_000_000, num_rel=40, in_dim=1152,
             heads=16, feat=128, layers=2, batch=128, num_neg=32,
             warmup_steps=3, timed_steps=10, epochs=60)
ZIPF = dict(warmup_steps=3, timed_steps=5, heavy_rows=16, random_rows=1_024)
# Head widths past the TRAIN model's 128: the library's default (config.py,
# 12 heads x 300), the widest the kernels take (1024), one not a multiple of
# 4, and TRAIN's own width on the same graph for the bf16 pair kernels,
# also at odd head counts (3 and 1), whose last head the pair kernels run
# unpaired: head tensor parallelism makes such tiles.
WIDE_SHAPES = ((12, 300), (4, 512), (2, 1024), (3, 301), (16, 128),
               (3, 128), (1, 128))
WIDE = dict(num_nodes=4_000, num_edges=40_000, num_rel=40, hub_degree=1_000)
# The library's default widths on TRAIN's graph: 12 heads x 300, one GAT
# layer (config.py), the rest of the TRAIN model as it is.
DEFAULT_WIDTH = dict(heads=12, feat=300, layers=1, warmup_steps=1,
                     timed_steps=3)
TRAINER = dict(nodes=20_000, triplets=25_000, num_rel=40, in_dim=1152,
               nn_pool=256, heads=16, feat=128, layers=2, batch=128,
               num_neg=32, every=100, train_ratio=0.9, bare_steps=100,
               max_over_bare=1.10, max_checkpoints=5, steps_per_call=8)
# Remat at TRAIN: 3 steps (1 warm-up, 2 timed) each way and precision, with
# TRAIN's dropout and an attention dropout (TRAIN has none) so that the
# seed drawn before the checkpointed layer is exercised too.
REMAT = dict(steps=3, warmup_steps=1, rel_attn_dropout=0.2)
# A graph of TRAIN's nodes and 8M edges, the size the JAX package's scanned
# propagate was made for (ops/pallas/kernels.py:479-481), and the bytes a
# graph may add per edge past the reckoning of its layout.
EDGES_8M = dict(num_edges=8_000_000, scan_segments=4, warmup_steps=1,
                timed_steps=2, margin=1.10, max_bytes_per_edge=64)
PARAM_BF16 = dict(steps=4, warmup_steps=1, param_dtype="bfloat16")
# fp16 projections (fp32 parameters) at TRAIN: 3 steps through the fp32
# kernels, the first step's loss held to the fp32 step's at
# TRAIN_LOSS_TOL. fp16 parameters on the AGREE model: 3 Adam steps on the
# card and on a CPU copy, whose finite flags must agree step by step (JAX's
# fp16 Adam goes non-finite, and the port takes the same steps).
FP16 = dict(steps=3, warmup_steps=1, compute_dtype="float16")
PARAM_FP16 = dict(steps=3, param_dtype="float16")
# Serving TRAIN's model: exports timed (and counted) per variant, and a
# batch of queries held to a float64 recomputation: scores within
# score_tol, ids equal wherever the float64 scores are not tied within
# tie_tol (an fp32 cosine over 1152 features is off by ~1e-7).
SERVE = dict(exports=3, queries=128, top_k=10, query_reps=5, score_tol=1e-5,
             tie_tol=1e-6)
# Same-bits limit where bits may differ: parameters after the same steps
# taken another way (remat, several steps a call).
SAME_TOL = 1e-6
FWD_CU = "relgat_projector_tpu_torch/csrc/relgat_fwd.cu"
BWD_CU = "relgat_projector_tpu_torch/csrc/relgat_bwd.cu"
TPU_FWD = "relgat_projector_tpu/ops/pallas/fused.py:116"  # _fused_kernel
TPU_BWD = "relgat_projector_tpu/ops/pallas/fused.py:433"  # _bwd_src_kernel
KERNEL_SOURCES = {
    "relgat_fwd": (FWD_CU, TPU_FWD),
    "relgat_bwd_src": (BWD_CU, TPU_BWD),
    "relgat_bwd_rel": (BWD_CU, TPU_BWD),
    # the TPU kernels' bf16 bodies: the bf16 `ps` stream of _fused_kernel,
    # the `packed_bf16` branch of _bwd_src_kernel
    "relgat_fwd_bf16": (FWD_CU, TPU_FWD),
    "relgat_bwd_src_bf16": (BWD_CU, TPU_BWD),
    "relgat_bwd_rel_bf16": (BWD_CU, TPU_BWD),
}
# (forward, backward src pass, backward relation reduction) of each variant
VARIANTS = {False: ("relgat_fwd", "relgat_bwd_src", "relgat_bwd_rel"),
            True: ("relgat_fwd_bf16", "relgat_bwd_src_bf16",
                   "relgat_bwd_rel_bf16")}
# At the train shapes a float64 copy of the fwd and bwd_src plain versions
# would need more than the card's 80 GB ([E, H, F] float64 temporaries are
# 16 GB each); relgat_bwd_rel's sums over 100k node rows are where fp32
# rounding in the plain version itself would reach ~1e-5 (W in float64 is
# 512 MB there). relgat_bwd_src is held to float64 on the out-edges of
# SRC_ROWS random source rows: among 16M (edge, head) logits a few lie
# within fp32 rounding of 0, where LeakyReLU's slope jumps from 1 to 0.2,
# and an fp32 reference may take the other side there.
EXACT_AT_TRAIN_SHAPES = ("relgat_bwd_rel", "relgat_bwd_rel_bf16")
SRC_ROWS = 3_000
# The kernels that read one H*F row per edge (h[src], g[dst]).
ROW_GATHERS = ("relgat_fwd", "relgat_bwd_src", "relgat_fwd_bf16",
               "relgat_bwd_src_bf16")
AGREE = dict(num_nodes=3_000, num_edges=30_000, num_rel=8, in_dim=64, heads=4,
             feat=32, layers=2, batch=64, num_neg=8)
AGREE_TOL = 1e-4  # the repo's activation parity contract
# The bf16 mode end to end against its plain route: any fp32 difference
# upstream of a bf16 rounding (of h in the forward, of g in the backward)
# moves a value near a rounding midpoint by a whole bf16 step (2^-8
# relative), so the two routes agree to bf16 precision, not to 1e-4. The
# plain route on the card against the same route on the CPU shows the size
# of those steps beside the kernels' result.
AGREE_BF16_TOL = 1e-2
# The JAX package's bf16 mode against fp32 (BENCH_NOTES.md, "End-of-round
# kernel revalidation"): relative to the largest value, the larger of its
# two dropout rates, measured on a TPU by scripts/tpu_kernel_check.py on the
# inputs ENVELOPE_CASE rebuilds. It is one draw of the TPU's rounding, which
# also rounds inside its dots; the port rounds only h and g, as JAX does on
# the CPU, and fails past ENVELOPE_MARGIN times it.
ENVELOPE = {"fwd": 8.372e-3, "dh": 8.500e-2, "dattn": 5.414e-3,
            "dbias": 3.399e-4}
ENVELOPE_MARGIN = 1.25
ENVELOPE_CASE = dict(num_nodes=20_000, num_edges=200_000, num_rel=12,
                     heads=4, feat=64, dropout_seed=7)  # seed_from_key(7)
TRAIN_LOSS_TOL = 1e-2  # first bf16 step's loss against the fp32 step's
BF16_MODE = dict(kernel_precision="default", compute_dtype="bfloat16")
BF16_FLAGS = ["--compute-dtype", "bfloat16", "--kernel-precision", "default"]
KERNELS = {k.__name__: k for k in kern.KERNELS}
PLAIN = {"relgat_fwd": kern.relgat_fwd_plain,
         "relgat_bwd_src": kern.relgat_bwd_src_plain,
         "relgat_bwd_rel": kern.relgat_bwd_rel_plain,
         "relgat_fwd_bf16": kern.relgat_fwd_bf16_plain,
         "relgat_bwd_src_bf16": kern.relgat_bwd_src_bf16_plain,
         "relgat_bwd_rel_bf16": kern.relgat_bwd_rel_bf16_plain}


class PhaseFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def emit(record: dict, out_lines: list) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    out_lines.append(line)


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def l2_rel_err(a, b) -> float:
    """||a - b|| / ||b||, over the whole tensor."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 3: kernel parity
# ---------------------------------------------------------------------------

def parity_graph(rng):
    p = PARITY
    n, e = p["num_nodes"], p["num_edges"]
    src = rng.integers(0, n, e)
    dst = rng.integers(1_000, n, e)           # rows 0..999: no in-edges
    et = rng.integers(0, p["num_rel"], e)
    heavy = rng.choice(np.arange(1_000, n), p["heavy_rows"], replace=False)
    k = p["heavy_rows"] * p["heavy_degree"]
    dst[:k] = np.repeat(heavy, p["heavy_degree"])
    src[k:k + 2_000] = dst[k:k + 2_000]       # self-loops
    m = k + 2_000
    src[m:m + 2_000] = src[m + 2_000:m + 4_000]  # multi-edges: repeated
    dst[m:m + 2_000] = dst[m + 2_000:m + 4_000]  # (src, dst, etype) triples
    et[m:m + 2_000] = et[m + 2_000:m + 4_000]
    hub = rng.choice(np.setdiff1d(np.arange(1_000, n), heavy))
    dst[m + 4_000:m + 4_000 + p["hub_degree"]] = hub
    return src, dst, et


def run_kernel_pair(inputs, *, seed, rate, exact, bf16=False, skip=()):
    """Each kernel of a variant and its plain version on the same inputs;
    returns the errors per output. The plain versions named in ``exact``
    run on float64 copies of those inputs, so their own rounding (and the
    run-to-run order of ``index_add_``'s atomics) stays out of the error.
    The backward kernels take the forward kernel's statistics as inputs,
    and relgat_bwd_rel takes relgat_bwd_src's W and B. The bf16 variants
    read h and g rounded to bf16 (float64 copies of those values are
    exact); S and gsum come from the fp32 g, as in the propagate. Kernels
    named in ``skip`` run without their plain version (and get no
    errors)."""
    h, g, attn, bias = inputs["h"], inputs["g"], inputs["attn"], inputs["bias"]
    csr = inputs["csr"]
    kw = dict(seed=seed, rate=rate, negative_slope=0.2, eps=1e-16)
    fwd, bwd_src, bwd_rel = VARIANTS[bf16]
    rows_h, rows_g = ((h.to(torch.bfloat16), g.to(torch.bfloat16)) if bf16
                      else (h, g))

    def ref(name, *args, **kwargs):
        if name in exact:
            args = [a.double() if isinstance(a, torch.Tensor) else a
                    for a in args]
        return PLAIN[name](*args, **kwargs)

    out_k, m, l, b = KERNELS[fwd](rows_h, attn, bias, csr, **kw)
    out_p = ref(fwd, rows_h, attn, bias, csr, **kw)[0]
    heads, _, f = attn.shape
    n = h.shape[0]
    s_dot = ((out_k - b[:, None]) * g).view(n, heads, f).sum(-1)
    gsum = g.sum(1)
    args = (rows_h, rows_g, attn, m, l, s_dot, gsum, csr)
    dh_k, w_k, b_k = KERNELS[bwd_src](*args, **kw)
    dattn_k, dbias_k = KERNELS[bwd_rel](rows_h, w_k, b_k)
    pairs = {fwd: {"out": (out_k, out_p)}}
    if bwd_src not in skip:
        dh_p, w_p, b_p = ref(bwd_src, *args, **kw)
        pairs[bwd_src] = {"dh": (dh_k, dh_p), "w": (w_k, w_p),
                          "b": (b_k, b_p)}
    dattn_p, dbias_p = ref(bwd_rel, rows_h, w_k, b_k)
    pairs[bwd_rel] = {"dattn": (dattn_k, dattn_p), "dbias": (dbias_k, dbias_p)}
    errs = {
        name: {
            key: {"max_rel_err": rel_err(a, b), "max_abs_err": abs_err(a, b)}
            for key, (a, b) in outs.items()
        }
        for name, outs in pairs.items()
    }
    return errs


def make_kernel_inputs(csr, n, heads, feat, num_rel, seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    hf = heads * feat

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    return {
        "csr": csr,
        "h": randn(n, hf, scale=0.5),
        "g": randn(n, hf),
        "attn": randn(heads, num_rel, feat, scale=0.1),
        "bias": randn(num_rel, scale=0.1),
    }


def phase_parity(card, out_lines):
    rng = np.random.default_rng(SEED)
    p = PARITY
    src, dst, et = parity_graph(rng)
    graph = build_graph(src, dst, et, p["num_nodes"],
                             num_rel=p["num_rel"], csr=True, device=DEVICE)
    csr = graph.csr
    indeg = np.bincount(dst, minlength=graph.num_nodes)
    check((indeg == 0).sum() >= 1_000
          and (indeg >= p["heavy_degree"]).sum() > p["heavy_rows"]
          and indeg.max() >= p["hub_degree"] and csr.fwd_num_split >= 1,
          "parity graph lacks empty, heavy or split rows")
    inputs = make_kernel_inputs(csr, graph.num_nodes, p["heads"],
                                p["feat"], p["num_rel"], SEED)
    seed = 123456789
    worst = 0.0
    for bf16, rate, with_bias in itertools.product(
            (False, True), (0.0, 0.3), (True, False)):
        case = dict(inputs)
        if not with_bias:
            case["bias"] = torch.zeros_like(inputs["bias"])
        errs = run_kernel_pair(case, seed=seed, rate=rate,
                               exact=KERNEL_SOURCES, bf16=bf16)
        torch.cuda.synchronize()
        for outs in errs.values():
            for e in outs.values():
                worst = max(worst, e["max_rel_err"])
        emit({"phase": "parity", "variant": "bf16" if bf16 else "fp32",
              "attn_dropout": rate, "rel_bias": with_bias, "errors": errs,
              "card": card}, out_lines)
    check(worst <= REL_TOL,
          f"kernel parity: max relative error {worst} > {REL_TOL}")
    return worst


def wide_graph(rng):
    """``WIDE``'s graph: uniform edges among rows 300.., and rows 200..299
    made by hand, so their degrees are exact: rows with 1, 2 and 3
    in-edges, rows with 1, 2 and 3 out-edges, self-loops, a (src, dst,
    relation) triple three times, and one row of ``hub_degree`` in-edges
    that the forward splits; rows 0..199 have no edges at all. Edge order
    shuffled."""
    c = WIDE
    n, r = c["num_nodes"], c["num_rel"]
    src = list(rng.integers(300, n, c["num_edges"]))
    dst = list(rng.integers(300, n, c["num_edges"]))
    for k in (1, 2, 3):
        for row in range(200 + 10 * (k - 1), 210 + 10 * (k - 1)):
            src += list(rng.integers(300, n, k))   # k in-edges
            dst += [row] * k
            src += [row + 30] * k                  # k out-edges
            dst += list(rng.integers(300, n, k))
    src += list(range(260, 280))                   # self-loops
    dst += list(range(260, 280))
    src += [280] * 4                               # a repeated triple
    dst += [281] * 4
    src += list(rng.integers(300, n, c["hub_degree"]))
    dst += [290] * c["hub_degree"]
    src, dst = np.array(src), np.array(dst)
    et = rng.integers(0, r, src.size)
    tail = 4 + c["hub_degree"]
    et[-tail:-tail + 4] = [3, 3, 3, 5]
    order = rng.permutation(src.size)
    return src[order], dst[order], et[order]


def phase_parity_wide(card, out_lines):
    """Every kernel, fp32 and bf16, against its float64 plain version at
    each of ``WIDE_SHAPES`` on ``wide_graph``, dropout 0 and 0.3."""
    c = WIDE
    src, dst, et = wide_graph(np.random.default_rng(SEED + 5))
    graph = build_graph(src, dst, et, c["num_nodes"], num_rel=c["num_rel"],
                        csr=True, device=DEVICE)
    csr = graph.csr
    check(csr.fwd_num_split == 1, "the wide parity graph lacks a split row")
    worst = 0.0
    for (heads, feat), bf16, rate in itertools.product(
            WIDE_SHAPES, (False, True), (0.0, 0.3)):
        inputs = make_kernel_inputs(csr, graph.num_nodes, heads, feat,
                                    c["num_rel"], SEED + heads)
        errs = run_kernel_pair(inputs, seed=424242, rate=rate,
                               exact=KERNEL_SOURCES, bf16=bf16)
        torch.cuda.synchronize()
        w = max(e["max_rel_err"] for outs in errs.values()
                for e in outs.values())
        worst = max(worst, w)
        emit({"phase": "parity_wide", "variant": "bf16" if bf16 else "fp32",
              "heads": heads, "feat": feat, "attn_dropout": rate,
              "max_rel_err": w, "errors": errs, "card": card}, out_lines)
        del inputs
    check(worst <= REL_TOL,
          f"kernel parity at wide heads: max relative error {worst} > "
          f"{REL_TOL}")
    return worst


def agree_grads(device, **model):
    """Loss and gradient leaves of one training forward and backward of
    the ``AGREE`` model on ``device``: its graph, batch and negatives from a
    seed, its weights and dropout draws from ``SEED``."""
    a = AGREE
    rng = np.random.default_rng(SEED + 3)
    n, e, b = a["num_nodes"], a["num_edges"], a["batch"]
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    et = rng.integers(0, a["num_rel"], e)
    emb = rng.standard_normal((n, a["in_dim"]), dtype=np.float32)
    batch = [torch.from_numpy(v).to(device) for v in (
        rng.integers(0, n, b), rng.integers(0, a["num_rel"], b),
        rng.integers(0, n, b))]
    neg = torch.from_numpy(rng.integers(0, n, (b, a["num_neg"]))).to(device)
    weight = torch.ones(b, device=device)
    graph = build_graph(src, dst, et, n, num_rel=a["num_rel"], csr=True,
                        device=device)
    x = torch.from_numpy(
        pad_node_embeddings(emb, graph.num_nodes)).to(device)
    tcfg = TrainConfig(train_batch_size=b, num_neg=a["num_neg"],
                       use_self_adv_neg=True)
    mcfg = ModelConfig(
        in_dim=a["in_dim"], num_rel=a["num_rel"], gat_out_dim=a["feat"],
        gat_heads=a["heads"], projection_layers=2,
        **{"gat_num_layers": a["layers"], "dropout": 0.3,
           "rel_attn_dropout": 0.3, "projection_dropout": 0.3, **model},
    )
    params = init_model(mcfg, seed=SEED, device=device)
    loss, _, grads = loss_and_grads(
        params, mcfg, tcfg, x, graph, *batch, weight,
        rng=RngStreams.from_seed(SEED, device), neg_dst=neg,
    )
    return [loss] + tree_leaves(grads)


def phase_agree(card, out_lines):
    """The kernel path against the plain path, end to end on the card: the
    same weights, graph, batch, negatives and dropout draws through one
    training forward and backward with ``use_pallas`` on and off. The loss
    and every gradient leaf agree to AGREE_TOL relative to the leaf's
    largest value."""
    a = AGREE
    results = {p: agree_grads(DEVICE, use_pallas=p) for p in (True, False)}
    torch.cuda.synchronize()
    errs = [rel_err(k, p) for k, p in zip(results[True], results[False])]
    emit({"phase": "agree", "card": card, **a, "loss": float(results[True][0]),
          "loss_plain": float(results[False][0]), "max_rel_err": max(errs),
          "tol": AGREE_TOL}, out_lines)
    check(all(np.isfinite(float(v.abs().max())) for v in results[True]),
          "kernel path gave non-finite loss or gradients")
    check(max(errs) <= AGREE_TOL,
          f"kernel path and plain path differ by {max(errs)} > {AGREE_TOL}")


def envelope_errors():
    """The propagate on ``ENVELOPE_CASE`` (scripts/tpu_kernel_check.py's
    inputs: seed 0, h ~ N(0, 1), attn x 0.3, bias x 0.1, the gradients of
    sum(sin(out))) through the bf16 and the fp32 kernels; per dropout rate,
    the bf16 result's error against the fp32 one relative to its largest
    value, for out, dh, dattn and dbias."""
    c = ENVELOPE_CASE
    rng = np.random.default_rng(0)
    n, e, r = c["num_nodes"], c["num_edges"], c["num_rel"]
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    et = rng.integers(0, r, e)
    graph = build_graph(src, dst, et, n, num_rel=r, csr=True, device=DEVICE)
    shape = (graph.num_nodes, c["heads"], c["feat"])
    h = rng.standard_normal(shape).astype(np.float32)
    attn = (rng.standard_normal((c["heads"], r, c["feat"])) * 0.3).astype(
        np.float32)
    bias = (rng.standard_normal(r) * 0.1).astype(np.float32)
    errs = {}
    for rate in (0.0, 0.3):
        res = {}
        for prec in ("default", "highest"):
            leaves = [torch.tensor(v, device=DEVICE, requires_grad=True)
                      for v in (h, attn, bias)]
            out = relgat_propagate_kernels(
                *leaves, graph.csr, attn_dropout_rate=rate,
                dropout_seed=c["dropout_seed"] if rate else None,
                kernel_precision=prec)[:n]
            grads = torch.autograd.grad(torch.sin(out).sum(), leaves)
            res[prec] = (out.detach(),) + grads
        errs[rate] = {k: rel_err(a, b) for k, a, b in zip(
            ENVELOPE, res["default"], res["highest"])}
    return errs


@contextlib.contextmanager
def plain_bf16_propagate():
    """The propagate's bf16 kernels replaced by their plain versions for
    the block: the kernels' route, in plain PyTorch, on the card. A
    reference for ``phase_agree_bf16`` only."""
    saved = propagate._KERNELS[True]
    propagate._KERNELS[True] = (kern.relgat_fwd_bf16_plain,
                                kern.relgat_bwd_src_bf16_plain,
                                kern.relgat_bwd_rel_bf16_plain)
    try:
        yield
    finally:
        propagate._KERNELS[True] = saved


def phase_agree_bf16(card, out_lines):
    """The ``AGREE`` model with ``kernel_precision="default"`` and fp32
    compute, so that only the kernels' bf16 rows differ from fp32.
    Attention dropout is on (its seeds come from the host generator);
    output and projection dropout are off, since the CPU's generator does
    not draw the card's masks.

    - the bf16 kernels on the card against the plain route on a CPU copy,
      loss and every gradient within AGREE_BF16_TOL, beside the plain route
      on the card against the same CPU copy (``plain_bf16_propagate``);
      the kernels themselves are held to 1e-5 in ``parity`` and
      ``kernels``;
    - the bf16 kernels against the fp32 kernels on the card, on that model
      (printed) and on the JAX envelope's own inputs (``envelope_errors``),
      which must stay within ENVELOPE_MARGIN x ENVELOPE."""
    mode = dict(use_pallas=True, kernel_precision="default", dropout=0.0,
                projection_dropout=0.0)
    card_bf16 = agree_grads(DEVICE, **mode)
    with plain_bf16_propagate():
        card_plain = agree_grads(DEVICE, **mode)
    cpu_bf16 = [v.to(DEVICE) for v in agree_grads("cpu", **mode)]
    card_fp32 = agree_grads(DEVICE, **dict(mode, kernel_precision="highest"))
    torch.cuda.synchronize()
    cpu_errs = [rel_err(k, p) for k, p in zip(card_bf16, cpu_bf16)]
    plain_errs = [rel_err(k, p) for k, p in zip(card_bf16, card_plain)]
    plain_cpu_errs = [rel_err(k, p) for k, p in zip(card_plain, cpu_bf16)]
    vs_fp32 = [rel_err(k, p) for k, p in zip(card_bf16, card_fp32)]
    env = envelope_errors()
    worst_env = {k: max(e[k] for e in env.values()) for k in ENVELOPE}
    emit({"phase": "agree_bf16", "card": card, **AGREE, **mode,
          "loss": float(card_bf16[0]), "loss_plain_cpu": float(cpu_bf16[0]),
          "max_rel_err_vs_cpu": max(cpu_errs),
          "max_rel_err_vs_plain_on_card": max(plain_errs),
          "plain_card_max_rel_err_vs_cpu": max(plain_cpu_errs),
          "tol": AGREE_BF16_TOL,
          "vs_fp32_kernels": {"loss": vs_fp32[0],
                              "max_grad": max(vs_fp32[1:]),
                              "per_leaf": vs_fp32[1:]},
          "envelope_case": ENVELOPE_CASE,
          "envelope_vs_fp32": {str(k): v for k, v in env.items()},
          "jax_envelope": ENVELOPE, "envelope_margin": ENVELOPE_MARGIN},
         out_lines)
    check(all(np.isfinite(float(v.abs().max())) for v in card_bf16),
          "bf16 kernel path gave non-finite loss or gradients")
    check(max(cpu_errs) <= AGREE_BF16_TOL,
          f"bf16 kernel path on the card and the plain route on the CPU "
          f"differ by {max(cpu_errs)} > {AGREE_BF16_TOL}")
    for k, err in worst_env.items():
        check(err <= ENVELOPE_MARGIN * ENVELOPE[k],
              f"bf16 {k} is {err} from fp32 on the envelope's inputs, past "
              f"{ENVELOPE_MARGIN} x the JAX envelope {ENVELOPE[k]}")


# ---------------------------------------------------------------------------
# Phase 4/5: train and export on the production model
# ---------------------------------------------------------------------------

def train_inputs(rng):
    t = TRAIN
    n, e = t["num_nodes"], t["num_edges"]
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    et = rng.integers(0, t["num_rel"], e)
    emb = rng.standard_normal((n, t["in_dim"]), dtype=np.float32)
    steps = t["warmup_steps"] + t["timed_steps"]
    picks = rng.integers(0, e, (steps, t["batch"]))  # triplets are edges
    return src, dst, et, emb, picks


def production_configs(**model):
    t = TRAIN
    mcfg = ModelConfig(**{
        "in_dim": t["in_dim"], "num_rel": t["num_rel"],
        "gat_out_dim": t["feat"], "gat_heads": t["heads"],
        "gat_num_layers": t["layers"], "dropout": 0.3,
        "project_to_input_size": True, "projection_layers": 2,
        "projection_dropout": 0.3, "scorer_type": "distmult",
        "use_pallas": True, **model,
    })
    tcfg = TrainConfig(
        epochs=t["epochs"], train_batch_size=t["batch"],
        num_neg=t["num_neg"], lr=2e-5, lr_scheduler="linear",
        weight_decay=1e-4, use_self_adv_neg=True, self_adv_alpha=1.0,
        relgat_weight=1.0, pos_cosine_weight=1.0, neg_cosine_weight=1.0,
        mse_weight=0.0,
    )
    return mcfg, tcfg


def step_matmul_flops(num_rows):
    """FLOPs of the train step's matrix products, from the shapes: every GAT
    projection and projection-head linear runs over all ``num_rows`` node
    rows, forward, weight gradient and (except the first GAT layer, whose
    input is the frozen embedding) input gradient. The head of 2 layers has
    a hidden width of H*F (``projection_hidden_dim`` 0)."""
    t = TRAIN
    hf = t["heads"] * t["feat"]
    dims = ([(t["in_dim"], hf)] + [(hf, hf)] * (t["layers"] - 1)
            + [(hf, hf), (hf, t["in_dim"])])
    return sum(2 * num_rows * k * m * (2 if i == 0 else 3)
               for i, (k, m) in enumerate(dims))


def edge_batches(src, et, dst, picks):
    """One (src, relation, dst) triplet batch per row of edge ids."""
    return [[torch.from_numpy(a[i]).to(DEVICE) for a in (src, et, dst)]
            for i in picks]


def train_steps(node_emb, graph, batches, warmup, **model):
    """The production model (``model`` overriding its config) from a seed
    and its Adam state, trained on ``batches``: ``warmup`` steps, then the
    rest timed. The launch counts and the peak memory cover all of them; no
    reference to an earlier state outlives its step. Returns (model config,
    train step, state, metrics, seconds per timed step, launch counts, the
    first step's loss)."""
    t = TRAIN
    mcfg, tcfg = production_configs(**model)
    total, warm = compute_total_and_warmup_steps(
        t["num_edges"], t["batch"], t["epochs"], None)
    sched = make_lr_schedule(tcfg.lr, "linear", total, warm)
    opt = make_optimizer(tcfg, sched)
    state = create_train_state(
        init_model(mcfg, seed=SEED, device=DEVICE), opt, seed=SEED + 1)
    step = make_train_step(mcfg, tcfg, opt, sched)
    weight = torch.ones(t["batch"], device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launch_counts()
    first_loss = None
    for batch in batches[:warmup]:
        state, metrics = step(state, node_emb, graph, *batch, weight)
        if first_loss is None:
            first_loss = float(metrics["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[warmup:]:
        state, metrics = step(state, node_emb, graph, *batch, weight)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (len(batches) - warmup)
    return (mcfg, step, state, metrics, step_s, kern.launch_counts(),
            first_loss)


def expected_launches(bf16, launches):
    """``launches`` of each kernel of the variant, none of the other's."""
    return {name: launches if name in VARIANTS[bf16] else 0
            for name in KERNELS}


def check_train(metrics, counts, expected, what):
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    check(np.isfinite(loss), f"{what} loss is not finite: {loss}")
    check(grad_norm > 0, f"{what} grad norm is {grad_norm}")
    for name, c in counts.items():
        check(c == expected[name],
              f"{what}: {name} launched {c} times, expected {expected[name]}")


def phase_train(card, out_lines, out_dir):
    t = TRAIN
    rng = np.random.default_rng(SEED)
    src, dst, et, emb, picks = train_inputs(rng)
    t0 = time.perf_counter()
    graph = build_graph(src, dst, et, t["num_nodes"],
                             num_rel=t["num_rel"], csr=True, device=DEVICE)
    node_emb = torch.from_numpy(
        pad_node_embeddings(emb, graph.num_nodes)).to(DEVICE)
    batches = edge_batches(src, et, dst, picks)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    mcfg, step, state, metrics, step_s, counts, first_loss = train_steps(
        node_emb, graph, batches, t["warmup_steps"])
    record = {
        "phase": "train", "card": card,
        "nodes": t["num_nodes"], "edges": t["num_edges"],
        "layers": t["layers"], "heads": t["heads"], "feat": t["feat"],
        "in_dim": t["in_dim"], "steps": len(batches),
        "timed_steps": t["timed_steps"], "step_ms": step_s * 1e3,
        "edge_messages_per_s": t["num_edges"] * t["layers"] / step_s,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "setup_s": setup_s, "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "step": int(state.step), "first_step_loss": first_loss,
        "launches": counts,
    }
    emit(record, out_lines)
    check_train(metrics, counts,
                expected_launches(False, t["layers"] * len(batches)), "train")

    weight = torch.ones(t["batch"], device=DEVICE)
    profile_steps(step, state, node_emb, graph, batches[0], weight,
                  step_s * 1e3, step_matmul_flops(graph.num_nodes), card,
                  out_lines, out_dir)

    before = kern.launch_counts()
    t0 = time.perf_counter()
    rep = get_node_repr(state.params, mcfg, node_emb, graph)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    after = kern.launch_counts()
    emit({"phase": "export", "card": card, "shape": list(rep.shape),
          "export_ms": export_s * 1e3,
          "forward_launches": after["relgat_fwd"] - before["relgat_fwd"]},
         out_lines)
    check(tuple(rep.shape) == (t["num_nodes"], t["in_dim"]),
          f"export shape {tuple(rep.shape)}")
    check(bool(torch.isfinite(rep).all()), "export has non-finite values")
    check(after["relgat_fwd"] - before["relgat_fwd"] == t["layers"],
          "export did not run the forward kernel once per layer")
    check(after["relgat_bwd_src"] == before["relgat_bwd_src"]
          and after["relgat_bwd_rel"] == before["relgat_bwd_rel"],
          "export ran a backward kernel")
    return (counts, graph, step_s * 1e3, node_emb, batches, first_loss,
            state.params, mcfg)


# ---------------------------------------------------------------------------
# Phase 5: serving the production model
# ---------------------------------------------------------------------------

def timed_exports(params, cfg, node_emb, graph):
    """``SERVE["exports"]`` calls of ``export_node_representations``:
    (the last result, ms per call, the calls' launch counts)."""
    n = SERVE["exports"]
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        rep = export_node_representations(params, cfg, node_emb, graph)
    torch.cuda.synchronize()
    return rep, (time.perf_counter() - t0) / n * 1e3, kern.launch_counts()


def check_serve_launches(counts, calls, layers, bf16, what):
    """The variant's forward kernel ``calls x layers`` times, no other."""
    fwd = VARIANTS[bf16][0]
    for name, c in counts.items():
        want = calls * layers if name == fwd else 0
        check(c == want, f"{what}: {name} launched {c} times, expected "
                         f"{want}")


def check_queries(params, cfg, rep, ids, scores, qidx, rel):
    """The top-k against a float64 recomputation on the same fp32
    representations: (max score error, positions compared, tied ones)."""
    s = SERVE
    params64 = tree_map(lambda t: t.double(), params)
    rep64 = rep.double()
    tq = transform_from_vectors(params64, cfg, rep64[qidx],
                                torch.tensor([rel], device=DEVICE))
    sims = l2_normalize(tq) @ l2_normalize(rep64).T
    top, top_ids = torch.topk(sims, s["top_k"] + 1)
    gaps = top[:, :-1] - top[:, 1:]                 # to the next rank
    before = torch.cat([torch.full_like(gaps[:, :1], float("inf")),
                        gaps[:, :-1]], dim=1)       # to the rank above
    untied = torch.minimum(gaps, before) > s["tie_tol"]
    score_err = float((scores.double() - top[:, :-1]).abs().max())
    same = bool((ids == top_ids[:, :-1])[untied].all())
    check(score_err <= s["score_tol"],
          f"query scores {score_err} from float64, past {s['score_tol']}")
    check(same, "query ids differ from float64 where scores are not tied")
    return score_err, int(untied.sum()), int((~untied).sum())


def phase_serve(card, params, mcfg, graph, node_emb):
    """Serve phase train's model at TRAIN's size: a reference round trip
    (``save_pretrained`` -> ``export_torch_checkpoint_dir`` ->
    ``import_torch_checkpoint_dir`` -> ``load_from_pretrained``) and the
    bf16 mode from its own directory, each exported through the kernels
    with the same bits as ``get_node_repr`` on the live parameters; then a
    batch of queries. Returns the serve line's numbers."""
    s, layers = SERVE, mcfg.gat_num_layers
    bf16_cfg = dataclasses.replace(mcfg, **BF16_MODE)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        work = Path(tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_pretrained(str(work / "port"), params, mcfg)
        export_torch_checkpoint_dir(str(work / "port"), str(work / "ref"),
                                    device=DEVICE)
        import_torch_checkpoint_dir(str(work / "ref"), str(work / "back"),
                                    device=DEVICE)
        loaded, cfg = load_from_pretrained(str(work / "back"),
                                           node_emb=node_emb, device=DEVICE)
        torch.cuda.synchronize()
        round_trip_s = time.perf_counter() - t0
        save_pretrained(str(work / "bf16"), params, bf16_cfg)
        loaded16, cfg16 = load_from_pretrained(str(work / "bf16"),
                                               node_emb=node_emb,
                                               device=DEVICE)
    check(cfg16 == bf16_cfg, f"the bf16 directory loads as {cfg16}")
    want = get_node_repr(params, mcfg, node_emb, graph)
    rep, export_ms, counts = timed_exports(
        loaded, dataclasses.replace(cfg, use_pallas=True), node_emb, graph)
    check_serve_launches(counts, s["exports"], layers, False, "serve fp32")
    check(torch.equal(rep, want),
          "the round trip's representations differ from the live model's: "
          f"max {abs_err(rep, want)}")
    want16 = get_node_repr(params, bf16_cfg, node_emb, graph)
    rep16, export16_ms, counts16 = timed_exports(loaded16, cfg16, node_emb,
                                                 graph)
    check_serve_launches(counts16, s["exports"], layers, True, "serve bf16")
    check(torch.equal(rep16, want16),
          "the bf16 directory's representations differ from the live "
          f"model's: max {abs_err(rep16, want16)}")
    del want, want16, rep16

    rng = np.random.default_rng(SEED + 5)
    qidx = torch.from_numpy(rng.integers(0, rep.shape[0], s["queries"])
                            ).to(DEVICE)
    rel = int(rng.integers(0, mcfg.num_rel))

    def query():
        return query_expansion(loaded, cfg, rep, rep[qidx], rel_id=rel,
                               top_k=s["top_k"])

    query_ms = cuda_ms(query, s["query_reps"])
    ids, scores = query()
    score_err, compared, tied = check_queries(loaded, cfg, rep, ids, scores,
                                              qidx, rel)
    return {"nodes": rep.shape[0], "edges": graph.num_real_edges,
            "export_ms": export_ms, "export_bf16_ms": export16_ms,
            "export_launches": {"fp32": counts, "bf16": counts16},
            "exports_timed": s["exports"], "queries": s["queries"],
            "top_k": s["top_k"], "query_ms": query_ms,
            "query_max_score_err": score_err, "query_ids_compared": compared,
            "query_ids_tied": tied, "round_trip_s": round_trip_s}


def phase_train_bf16(card, out_lines, out_dir, graph, node_emb, batches,
                     fp32_first_loss):
    """``TRAIN`` in the bf16 mode (``kernel_precision="default"``,
    ``compute_dtype="bfloat16"``) on the train phase's graph, embeddings,
    batches, weights and generator seeds: the first step's loss against
    the fp32 one's, the launches of each variant, and the profile."""
    t = TRAIN
    torch.cuda.empty_cache()
    mcfg, step, state, metrics, step_s, counts, first_loss = train_steps(
        node_emb, graph, batches, t["warmup_steps"], **BF16_MODE)
    loss_rel = abs(first_loss - fp32_first_loss) / abs(fp32_first_loss)
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "train_bf16", "card": card, **BF16_MODE,
          "nodes": t["num_nodes"], "edges": t["num_edges"],
          "layers": t["layers"], "heads": t["heads"], "feat": t["feat"],
          "in_dim": t["in_dim"], "steps": len(batches),
          "timed_steps": t["timed_steps"], "step_ms": step_s * 1e3,
          "edge_messages_per_s": t["num_edges"] * t["layers"] / step_s,
          "max_memory_allocated_bytes": peak,
          "loss": float(metrics["loss"]),
          "grad_norm": float(metrics["grad_norm"]), "step": int(state.step),
          "first_step_loss": first_loss,
          "first_step_loss_fp32": fp32_first_loss,
          "first_step_loss_rel_diff": loss_rel, "tol": TRAIN_LOSS_TOL,
          "launches": counts}, out_lines)
    check_train(metrics, counts,
                expected_launches(True, t["layers"] * len(batches)),
                "train_bf16")
    check(loss_rel <= TRAIN_LOSS_TOL,
          f"first bf16 step's loss {first_loss} is {loss_rel} from the fp32 "
          f"step's {fp32_first_loss}")
    weight = torch.ones(t["batch"], device=DEVICE)
    profile_steps(step, state, node_emb, graph, batches[0], weight,
                  step_s * 1e3, step_matmul_flops(graph.num_nodes), card,
                  out_lines, out_dir, phase="profile_bf16")
    return counts, {"step_ms": step_s * 1e3, "peak": peak}


def phase_train_default(card, out_lines, graph, node_emb, batches):
    """The library's default widths (``DEFAULT_WIDTH``: 12 heads x 300, one
    GAT layer) on the train phase's graph, embeddings and batches, in fp32
    and in the bf16 mode: a few steps each, every kernel of the variant
    launched layers x steps times. Returns each variant's launch counts."""
    d = DEFAULT_WIDTH
    steps = d["warmup_steps"] + d["timed_steps"]
    model = dict(gat_heads=d["heads"], gat_out_dim=d["feat"],
                 gat_num_layers=d["layers"])
    counts = {}
    for bf16 in (False, True):
        torch.cuda.empty_cache()
        mode = BF16_MODE if bf16 else {}
        _, _, state, metrics, step_s, c, first = train_steps(
            node_emb, graph, batches[:steps], d["warmup_steps"], **model,
            **mode)
        emit({"phase": "train_default_width", "card": card,
              "variant": "bf16" if bf16 else "fp32", **model,
              "nodes": TRAIN["num_nodes"], "edges": TRAIN["num_edges"],
              "steps": steps, "timed_steps": d["timed_steps"],
              "step_ms": step_s * 1e3,
              "edge_messages_per_s": (TRAIN["num_edges"] * d["layers"]
                                      / step_s),
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "first_step_loss": first, "loss": float(metrics["loss"]),
              "grad_norm": float(metrics["grad_norm"]), "launches": c},
             out_lines)
        check_train(metrics, c, expected_launches(bf16, d["layers"] * steps),
                    f"train_default_width ({'bf16' if bf16 else 'fp32'})")
        counts.update({k: c[k] for k in VARIANTS[bf16]})
        del state, metrics
    return counts


def max_rel_diff(a_leaves, b_leaves):
    """(every pair equal bit for bit, the largest relative difference)."""
    same = all(torch.equal(a, b) for a, b in zip(a_leaves, b_leaves))
    return same, max(rel_err(a, b) for a, b in zip(a_leaves, b_leaves))


def phase_remat(card, out_lines, graph, node_emb, batches):
    """``TRAIN`` with ``remat`` on and off, in fp32 and in the bf16 mode, on
    the train phase's graph, embeddings, batches, weights and generator
    seeds, with dropout: the parameters after the steps agree (bit for bit
    expected, SAME_TOL at most), the peak memory with remat is lower, and
    relgat_fwd runs twice a layer a step under remat (the recompute in the
    backward), the backward kernels once."""
    r, t = REMAT, TRAIN
    for bf16 in (False, True):
        mode = BF16_MODE if bf16 else {}
        fwd, bwd_src, bwd_rel = VARIANTS[bf16]
        runs = {}
        for remat in (False, True):
            torch.cuda.empty_cache()
            _, _, state, metrics, step_s, counts, _ = train_steps(
                node_emb, graph, batches[:r["steps"]], r["warmup_steps"],
                remat=remat, rel_attn_dropout=r["rel_attn_dropout"], **mode)
            runs[remat] = dict(
                params=[p.detach() for p in tree_leaves(state.params)],
                step_ms=step_s * 1e3, counts=counts, loss=float(metrics["loss"]),
                peak=torch.cuda.max_memory_allocated())
            del state, metrics
            per_step = r["steps"] * t["layers"]
            check(counts[fwd] == per_step * (2 if remat else 1)
                  and counts[bwd_src] == counts[bwd_rel] == per_step,
                  f"remat={remat} ({'bf16' if bf16 else 'fp32'}): launches "
                  f"{counts}")
        same, diff = max_rel_diff(runs[True]["params"], runs[False]["params"])
        emit({"phase": "remat", "card": card,
              "variant": "bf16" if bf16 else "fp32", "steps": r["steps"],
              "timed_steps": r["steps"] - r["warmup_steps"],
              "dropout": 0.3, "rel_attn_dropout": r["rel_attn_dropout"],
              "params_bit_identical": same, "params_max_rel_diff": diff,
              **{f"{k}_{'remat' if on else 'no_remat'}": runs[on][key]
                 for on in (False, True)
                 for k, key in (("step_ms", "step_ms"),
                                ("max_memory_allocated_bytes", "peak"),
                                ("launches", "counts"), ("loss", "loss"))},
              "memory_saved_bytes": runs[False]["peak"] - runs[True]["peak"]},
             out_lines)
        check(diff <= SAME_TOL, f"remat changed the parameters by {diff}")
        check(runs[True]["peak"] < runs[False]["peak"],
              f"remat's peak {runs[True]['peak']} is not below "
              f"{runs[False]['peak']}")


def layout_bytes(graph, heads, feat):
    """The bytes on the card that a graph's layout holds, from its arrays'
    shapes: the COO (3 x int64 an edge), the dst- and src-CSR (6 x int32 an
    edge, 2 row pointers), the forward's work plan (4 x int32 an item, 3 x
    int32 a split row) and the split rows' partials, which the forward
    allocates (heads x (feat + 2) x fp32 and one fp64 a slot)."""
    c = graph.csr
    coo = 3 * 8 * graph.num_edges_padded
    csr = 6 * 4 * c.num_edges + 2 * 4 * (c.num_nodes + 1)
    plan = 4 * 4 * c.fwd_num_items + 3 * 4 * c.fwd_num_split
    parts = c.fwd_num_parts * (heads * (feat + 2) * 4 + 8)
    return coo + csr + plan + parts


def phase_edges_8m(card, out_lines, graph_1m, node_emb):
    """``TRAIN``'s model on a seeded uniform graph of its 100,000 nodes and
    8,000,000 edges, in fp32 and in the bf16 mode: the steps with
    ``scan_segments=4`` against the same steps without (the same bits: the
    kernels run unsegmented), step time, edge-messages/s and each kernel's
    time at 8M edges. Memory: the steps' peak on the 1M-edge graph, then,
    with that graph still held, on the 8M-edge graph; the growth per edge
    of the 8M graph must stay within its layout's reckoning
    (``layout_bytes``) + 10% and at most 64 bytes, which no E-sized float
    tensor would."""
    t, c = TRAIN, EDGES_8M
    rng = np.random.default_rng(SEED + 17)
    n, e = t["num_nodes"], c["num_edges"]
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    et = rng.integers(0, t["num_rel"], e)
    batches = edge_batches(src, et, dst, rng.integers(
        0, e, (c["warmup_steps"] + c["timed_steps"], t["batch"])))
    launches = t["layers"] * len(batches)

    def run(graph, **model):
        torch.cuda.empty_cache()
        _, _, state, metrics, step_s, counts, _ = train_steps(
            node_emb, graph, batches, c["warmup_steps"], **model)
        return dict(leaves=state_leaves(state), step_s=step_s,
                    counts=counts, loss=float(metrics["loss"]),
                    peak=torch.cuda.max_memory_allocated())

    peaks_1m = {bf16: run(graph_1m, **(BF16_MODE if bf16 else {}))["peak"]
                for bf16 in (False, True)}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    graph = build_graph(src, dst, et, n, num_rel=t["num_rel"], csr=True,
                        device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del src, dst, et
    reckoned = layout_bytes(graph, t["heads"], t["feat"]) / e
    print(f"edges_8m: the layout reckons {reckoned:.3f} bytes an edge (COO "
          f"24, CSR 24, row pointers, plan and partials the rest)",
          flush=True)
    for bf16 in (False, True):
        mode = BF16_MODE if bf16 else {}
        plain = run(graph, **mode)
        scanned = run(graph, scan_segments=c["scan_segments"], **mode)
        same = all(torch.equal(a, b)
                   for a, b in zip(plain["leaves"], scanned["leaves"]))
        per_edge = (plain["peak"] - peaks_1m[bf16]) / e
        emit({"phase": "edges_8m", "card": card,
              "variant": "bf16" if bf16 else "fp32", "nodes": n, "edges": e,
              "graph_build_s": build_s, "steps": len(batches),
              "timed_steps": c["timed_steps"],
              "scan_segments": c["scan_segments"],
              "scan_segments_bit_identical": same,
              "max_memory_allocated_bytes_1m": peaks_1m[bf16],
              "max_memory_allocated_bytes_8m": plain["peak"],
              "growth_bytes_per_edge": per_edge,
              "reckoned_bytes_per_edge": reckoned,
              "step_ms": plain["step_s"] * 1e3,
              "step_ms_scan_segments": scanned["step_s"] * 1e3,
              "edge_messages_per_s": e * t["layers"] / plain["step_s"],
              "loss": plain["loss"], "launches": plain["counts"]},
             out_lines)
        check(np.isfinite(plain["loss"]), f"edges_8m: loss {plain['loss']}")
        check(same, "edges_8m: scan_segments=4 changed the steps' bits")
        check(per_edge <= c["margin"] * reckoned
              and per_edge <= c["max_bytes_per_edge"],
              f"edges_8m: the peak grew {per_edge:.2f} bytes an edge, past "
              f"{c['margin']} x the reckoned {reckoned:.2f} or "
              f"{c['max_bytes_per_edge']}")
        check(all(r["counts"] == expected_launches(bf16, launches)
                  for r in (plain, scanned)),
              f"edges_8m: launches {plain['counts']} and "
              f"{scanned['counts']}, expected {launches} of each "
              f"{'bf16' if bf16 else 'fp32'} kernel")
        del plain, scanned
    kernel_times(graph, card, out_lines)
    del graph, batches
    torch.cuda.empty_cache()


def kernel_times(graph, card, out_lines):
    """Each kernel of both variants timed on ``graph`` at ``TRAIN``'s widths
    (no plain version: its [E, H, F] temporaries would not fit at 8M
    edges; parity is held on the other graphs)."""
    t = TRAIN
    csr, n = graph.csr, graph.num_nodes
    inputs = make_kernel_inputs(csr, n, t["heads"], t["feat"], t["num_rel"],
                                SEED + 7)
    kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    times = {}
    for bf16 in (False, True):
        fwd, bwd_src, bwd_rel = VARIANTS[bf16]
        h, g = inputs["h"], inputs["g"]
        if bf16:
            h, g = h.to(torch.bfloat16), g.to(torch.bfloat16)
        attn, bias = inputs["attn"], inputs["bias"]
        out, m, l, b = KERNELS[fwd](h, attn, bias, csr, **kw)
        s_dot = ((out - b[:, None]) * inputs["g"]).view(
            n, t["heads"], t["feat"]).sum(-1)
        gsum = inputs["g"].sum(1)
        _, w, bsum = KERNELS[bwd_src](h, g, attn, m, l, s_dot, gsum, csr, **kw)
        times[fwd] = cuda_ms(lambda: KERNELS[fwd](h, attn, bias, csr, **kw),
                             reps=10, warmup=2)
        times[bwd_src] = cuda_ms(lambda: KERNELS[bwd_src](
            h, g, attn, m, l, s_dot, gsum, csr, **kw), reps=10, warmup=2)
        times[bwd_rel] = cuda_ms(lambda: KERNELS[bwd_rel](h, w, bsum),
                                 reps=10, warmup=2)
        del out, m, l, b, w, bsum
    emit({"phase": "kernels_8m", "card": card, "edges": csr.num_edges,
          "heads": t["heads"], "feat": t["feat"], "ms": times}, out_lines)


def phase_param_bf16(card, out_lines, graph, node_emb, batches, bf16_record):
    """``TRAIN`` with bf16 parameters in the bf16 mode for a few steps:
    every parameter and Adam moment stays bf16, the loss is finite, each
    bf16 kernel launches layers x steps times; then the ``AGREE`` model with
    bf16 parameters through the kernels on the card against the same route
    on a CPU copy, within AGREE_BF16_TOL. Peak memory and step time beside
    ``train_bf16``'s."""
    c, t = PARAM_BF16, TRAIN
    torch.cuda.empty_cache()
    _, _, state, metrics, step_s, counts, _ = train_steps(
        node_emb, graph, batches[:c["steps"]], c["warmup_steps"],
        param_dtype=c["param_dtype"], **BF16_MODE)
    peak = torch.cuda.max_memory_allocated()
    dtypes = {str(x.dtype) for x in (
        tree_leaves(state.params) + tree_leaves(state.opt_state.mu)
        + tree_leaves(state.opt_state.nu))}
    del state
    mode = dict(use_pallas=True, param_dtype=c["param_dtype"], dropout=0.0,
                projection_dropout=0.0, **BF16_MODE)
    on_card = agree_grads(DEVICE, **mode)
    on_cpu = [v.to(DEVICE) for v in agree_grads("cpu", **mode)]
    errs = [rel_err(k, p) for k, p in zip(on_card, on_cpu)]
    emit({"phase": "param_bf16", "card": card, **BF16_MODE,
          "param_dtype": c["param_dtype"], "steps": c["steps"],
          "timed_steps": c["steps"] - c["warmup_steps"],
          "step_ms": step_s * 1e3,
          "edge_messages_per_s": t["num_edges"] * t["layers"] / step_s,
          "max_memory_allocated_bytes": peak,
          "train_bf16_step_ms": bf16_record["step_ms"],
          "train_bf16_max_memory_allocated_bytes": bf16_record["peak"],
          "state_dtypes": sorted(dtypes), "loss": float(metrics["loss"]),
          "launches": counts, "agree_max_rel_err_vs_cpu": max(errs),
          "tol": AGREE_BF16_TOL}, out_lines)
    check_train(metrics, counts,
                expected_launches(True, t["layers"] * c["steps"]),
                "param_bf16")
    check(dtypes == {"torch.bfloat16"},
          f"param_bf16: parameters and moments are {sorted(dtypes)}")
    check(max(errs) <= AGREE_BF16_TOL,
          f"param_bf16: the kernel route on the card and on the CPU differ "
          f"by {max(errs)} > {AGREE_BF16_TOL}")


def phase_train_fp16(card, out_lines, graph, node_emb, batches,
                     fp32_first_loss):
    """``TRAIN`` with fp16 projections (``compute_dtype="float16"``, fp32
    parameters) on the train phase's graph, embeddings, batches and seeds:
    ``h`` is still the fp32 product, so each fp32 kernel launches layers x
    steps times and the bf16 ones never; the first step's loss within
    TRAIN_LOSS_TOL of the fp32 step's; step time and peak memory."""
    c, t = FP16, TRAIN
    torch.cuda.empty_cache()
    _, _, state, metrics, step_s, counts, first_loss = train_steps(
        node_emb, graph, batches[:c["steps"]], c["warmup_steps"],
        compute_dtype=c["compute_dtype"])
    peak = torch.cuda.max_memory_allocated()
    loss_rel = abs(first_loss - fp32_first_loss) / abs(fp32_first_loss)
    dtypes = sorted({str(x.dtype) for x in tree_leaves(state.params)})
    del state
    emit({"phase": "train_fp16", "card": card,
          "compute_dtype": c["compute_dtype"], "steps": c["steps"],
          "timed_steps": c["steps"] - c["warmup_steps"],
          "step_ms": step_s * 1e3,
          "edge_messages_per_s": t["num_edges"] * t["layers"] / step_s,
          "max_memory_allocated_bytes": peak, "param_dtypes": dtypes,
          "loss": float(metrics["loss"]), "first_step_loss": first_loss,
          "first_step_loss_fp32": fp32_first_loss,
          "first_step_loss_rel_diff": loss_rel, "tol": TRAIN_LOSS_TOL,
          "launches": counts}, out_lines)
    check_train(metrics, counts,
                expected_launches(False, t["layers"] * c["steps"]),
                "train_fp16")
    check(loss_rel <= TRAIN_LOSS_TOL,
          f"first fp16 step's loss {first_loss} is {loss_rel} from the fp32 "
          f"step's {fp32_first_loss}")


def agree_steps(device, steps, **model):
    """Each step's ``(finite, nonfinite_scores, loss)`` over ``steps`` Adam
    steps of the ``AGREE`` model on ``device`` through the kernel route,
    on one batch with injected negatives and no dropout but the attention
    hash's (the same draws on every device)."""
    a = AGREE
    rng = np.random.default_rng(SEED + 4)
    n, e, b = a["num_nodes"], a["num_edges"], a["batch"]
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    et = rng.integers(0, a["num_rel"], e)
    emb = rng.standard_normal((n, a["in_dim"]), dtype=np.float32)
    batch = [torch.from_numpy(v).to(device) for v in (
        rng.integers(0, n, b), rng.integers(0, a["num_rel"], b),
        rng.integers(0, n, b))]
    neg = torch.from_numpy(rng.integers(0, n, (b, a["num_neg"]))).to(device)
    graph = build_graph(src, dst, et, n, num_rel=a["num_rel"], csr=True,
                        device=device)
    x = torch.from_numpy(
        pad_node_embeddings(emb, graph.num_nodes)).to(device)
    tcfg = TrainConfig(train_batch_size=b, num_neg=a["num_neg"], lr=1e-3,
                       lr_scheduler="constant", use_self_adv_neg=True)
    mcfg = ModelConfig(
        in_dim=a["in_dim"], num_rel=a["num_rel"], gat_out_dim=a["feat"],
        gat_heads=a["heads"], gat_num_layers=a["layers"],
        projection_layers=2, dropout=0.0, rel_attn_dropout=0.3,
        projection_dropout=0.0, use_pallas=True, **model)
    sched = make_lr_schedule(tcfg.lr, "constant", steps, 0)
    opt = make_optimizer(tcfg, sched)
    state = create_train_state(init_model(mcfg, seed=SEED, device=device),
                               opt, seed=SEED)
    step = make_train_step(mcfg, tcfg, opt, sched)
    out = []
    for _ in range(steps):
        state, m = step(state, x, graph, *batch,
                        torch.ones(b, device=device), neg_dst=neg)
        loss = float(m["loss"])
        out.append((bool(m["finite"]), int(m["nonfinite_scores"]),
                    loss if np.isfinite(loss) else None))
    return out


def phase_param_fp16(card, out_lines):
    """The ``AGREE`` model with fp16 parameters, ``PARAM_FP16["steps"]``
    Adam steps through the kernels on the card and on a CPU copy (their
    plain versions): each step's finite flag and count of non-finite scores
    equal, and the finite steps' losses within AGREE_BF16_TOL."""
    c = PARAM_FP16
    kern.reset_launch_counts()
    on_card = agree_steps(DEVICE, c["steps"], param_dtype=c["param_dtype"])
    counts = kern.launch_counts()
    on_cpu = agree_steps("cpu", c["steps"], param_dtype=c["param_dtype"])
    loss_errs = [abs(k[2] - p[2]) / abs(p[2])
                 for k, p in zip(on_card, on_cpu) if p[0]]
    emit({"phase": "param_fp16", "card": card,
          "param_dtype": c["param_dtype"], "steps": c["steps"],
          "card_steps": on_card, "cpu_steps": on_cpu,
          "finite_loss_max_rel_err": max(loss_errs, default=0.0),
          "tol": AGREE_BF16_TOL, "launches": counts}, out_lines)
    check([k[:2] for k in on_card] == [p[:2] for p in on_cpu],
          f"param_fp16: the card's steps {on_card} and the CPU's {on_cpu} "
          "differ in their finite flags")
    check(max(loss_errs, default=0.0) <= AGREE_BF16_TOL,
          f"param_fp16: finite losses differ by {loss_errs}")
    check(counts["relgat_fwd"] == AGREE["layers"] * c["steps"],
          f"param_fp16: relgat_fwd launched {counts['relgat_fwd']} times")


def profile_steps(step, state, node_emb, graph, batch, weight, step_ms,
                  matmul_flops, card, out_lines, out_dir, phase="profile"):
    """Where the step's device time goes, from torch.profiler over two
    steps, through the package's ``utils.profiling.trace``. The idle share is
    one minus the device's busy time per step over ``step_ms``, the step
    time measured without the profiler (the profiled window's own wall time
    includes the profiler's start-up). Diagnostic only: a profiler that
    cannot trace here is reported as not measured and fails nothing. The
    line and the trace's directory (under ``out_dir``) are named after
    ``phase``."""
    steps = 2
    name = "trace" if phase == "profile" else f"{phase}_trace"
    try:
        torch.cuda.synchronize()
        with contextlib.ExitStack() as stack:
            log_dir = (out_dir / f"chip_smoke_{name}" if out_dir is not None
                       else stack.enter_context(tempfile.TemporaryDirectory()))
            with trace(str(log_dir), worker_name=phase) as prof:
                for _ in range(steps):
                    state, _ = step(state, node_emb, graph, *batch, weight)
                torch.cuda.synchronize()
        groups = {"relgat_kernels": 0.0, "gemm": 0.0, "other": 0.0}
        top = []
        for evt in prof.key_averages():
            if getattr(evt, "device_type", None) is None or \
                    evt.device_type.name != "CUDA":
                continue
            us = float(getattr(evt, "self_device_time_total", 0.0))
            name = evt.key
            low = name.lower()
            if "relgat" in low:
                groups["relgat_kernels"] += us
            elif any(k in low for k in ("gemm", "cutlass", "sm90_", "nvjet")):
                groups["gemm"] += us
            else:
                groups["other"] += us
            top.append((us, name[:90]))
        busy_ms = sum(groups.values()) / 1e3 / steps
        top.sort(reverse=True)
        emit({"phase": phase, "card": card, "steps": steps,
              "device_busy_ms_per_step": busy_ms, "step_ms": step_ms,
              "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
              "device_ms_per_step_by_group": {
                  k: v / 1e3 / steps for k, v in groups.items()},
              "matmul_flop_per_step": matmul_flops,
              "gemm_flop_per_s": (matmul_flops / (groups["gemm"] / 1e6 / steps)
                                  if groups["gemm"] else None),
              "top_kernels_ms_per_step": [[n, u / 1e3 / steps]
                                          for u, n in top[:12]]},
             out_lines)
    except Exception as exc:  # the profiler is diagnostic, not a phase
        emit({"phase": phase, "card": card,
              "not_measured": f"{type(exc).__name__}: {exc}"}, out_lines)


# ---------------------------------------------------------------------------
# Phase 6: kernels line
# ---------------------------------------------------------------------------

def bounds(n, e, heads, feat, num_rel, row_bytes=4, n_dst=None,
           dropout=False):
    """(bytes, flops) each kernel must move and do on these inputs: every
    input read once, every output written once; the rows of h and g are
    ``row_bytes`` a value (2 in the bf16 variants), all else 4 (fp32,
    int32). ``n`` counts the source rows (h, dh, W, B) and ``n_dst`` (by
    default ``n``) the destination rows (g, out and the statistics); with
    ``dropout`` the forward also reads each edge's canonical id.
    ``bwd_pair`` is the whole function of the TPU backward kernel that the
    two backward kernels share: h, g, attn, the statistics and the src-CSR
    in, dh, dattn and dbias out."""
    nd = n if n_dst is None else n_dst
    hf = heads * feat
    w = 4  # bytes of fp32 and int32
    rows = row_bytes * n * hf  # one [N_src, H*F] array of h
    grows = row_bytes * nd * hf  # one [N, H*F] array of g
    attn = heads * num_rel * feat
    stats = 3 * nd * heads + nd + (n + 1) + 3 * e  # m, l, S, gsum, src-CSR
    de_flops = e * heads * (8 * feat + 16)
    return {
        "relgat_fwd": (
            rows + w * (nd * hf + attn + num_rel + (nd + 1)
                        + (3 if dropout else 2) * e + 2 * nd * heads + nd),
            e * heads * (5 * feat + 10) + 2 * nd * hf,
        ),
        "relgat_bwd_src": (
            rows + grows + w * (n * hf + attn + stats + n * heads * num_rel
                                + n * num_rel),
            de_flops + e,
        ),
        "relgat_bwd_rel": (
            rows + w * (n * heads * num_rel + n * num_rel + attn + num_rel),
            2 * n * heads * num_rel * feat + n * num_rel,
        ),
        "bwd_pair": (
            rows + grows + w * (n * hf + 2 * attn + stats + num_rel),
            de_flops + 2 * e * hf,
        ),
    }


def bound_ms(nbytes, flops):
    """(least ms on this card, what bounds it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by


def kernel_rows(inputs, bf16, counts, card, out_lines):
    """The kernels line's rows of one variant on ``TRAIN``'s graph at the
    widths of ``inputs``, and its ``bwd_pair`` line. The bf16 forward and
    src pass must also give the same bits over two calls."""
    csr = inputs["csr"]
    n = inputs["h"].shape[0]
    kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    h, g, attn, bias = inputs["h"], inputs["g"], inputs["attn"], inputs["bias"]
    heads, num_rel, feat = attn.shape
    fwd, bwd_src, bwd_rel = VARIANTS[bf16]
    rh, rg = (h.to(torch.bfloat16), g.to(torch.bfloat16)) if bf16 else (h, g)
    out, m, l, b = KERNELS[fwd](rh, attn, bias, csr, **kw)
    s_dot = ((out - b[:, None]) * g).view(n, heads, feat).sum(-1)
    gsum = g.sum(1)
    _, w, bsum = KERNELS[bwd_src](rh, rg, attn, m, l, s_dot, gsum, csr, **kw)
    same_bits = None
    if bf16:
        again = KERNELS[fwd](rh, attn, bias, csr, **kw)
        same_bits = all(torch.equal(x, y) for x, y in
                        zip((out, m, l, b), again))
        first = KERNELS[bwd_src](rh, rg, attn, m, l, s_dot, gsum, csr, **kw)
        second = KERNELS[bwd_src](rh, rg, attn, m, l, s_dot, gsum, csr, **kw)
        same_bits = same_bits and all(torch.equal(x, y)
                                      for x, y in zip(first, second))
        del again, first, second
        check(same_bits, f"{fwd} or {bwd_src} gave other bits in a second "
                         f"call at {heads} x {feat}")
    calls = {
        fwd: lambda f: f(rh, attn, bias, csr, **kw),
        bwd_src: lambda f: f(rh, rg, attn, m, l, s_dot, gsum, csr, **kw),
        bwd_rel: lambda f: f(rh, w, bsum),
    }
    # One PyTorch call computing the same function, timed as a yardstick
    # only: dattn of relgat_bwd_rel is W^T h per head. The other kernels'
    # functions have no such call, nor has relgat_bwd_rel_bf16's (fp32 W
    # against bf16 h: einsum takes one type).
    h3 = h.view(n, heads, feat)
    library = ({} if bf16 else
               {bwd_rel: lambda: torch.einsum("nhr,nhf->hrf", w, h3)})
    # Comparisons and timings here are not part of the main path's counts.
    errs = run_kernel_pair(inputs, seed=None, rate=0.0,
                           exact=EXACT_AT_TRAIN_SHAPES, bf16=bf16,
                           skip=(bwd_src,))
    torch.cuda.empty_cache()
    errs[bwd_src] = src_rows_errors(bwd_src, (rh, rg, attn, m, l, s_dot, gsum),
                                    csr, kw)
    torch.cuda.synchronize()
    row_bytes = rh.element_size()
    bnd = bounds(n, csr.num_edges, heads, feat, num_rel,
                 row_bytes=row_bytes)
    rows = []
    for name, kind in zip(VARIANTS[bf16], VARIANTS[False]):
        source, replaces = KERNEL_SOURCES[name]
        ms = cuda_ms(lambda: calls[name](KERNELS[name]), reps=10, warmup=2)
        plain_ms = cuda_ms(lambda: calls[name](PLAIN[name]), reps=2)
        lib_ms = (cuda_ms(library[name], reps=10, warmup=2)
                  if name in library else None)
        nbytes, flops = bnd[kind]
        best, by = bound_ms(nbytes, flops)
        worst = max(errs[name].values(), key=lambda x: x["max_rel_err"])
        row = {
            "name": name, "graph": "uniform", "heads": heads, "feat": feat,
            "route": "cuda",
            "source": source, "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(x["max_abs_err"] for x in errs[name].values()),
            "max_rel_err": worst["max_rel_err"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": best, "bound_by": by, "library_ms": lib_ms,
            "reference": ("float64" if name in EXACT_AT_TRAIN_SHAPES
                          else f"float64, {SRC_ROWS} src rows"
                          if name == bwd_src else "float32"),
            "bytes": nbytes, "flops": flops, "card": card,
        }
        if same_bits is not None and name != bwd_rel:
            row["same_bits_twice"] = same_bits
        if name in ROW_GATHERS:
            # what the design reads besides: one H*F row per edge (h[src]
            # in the forward, g[dst] in relgat_bwd_src)
            row["row_gather_bytes"] = row_bytes * csr.num_edges * heads * feat
        emit({"phase": "kernel", **row, "errors": errs[name]}, out_lines)
        rows.append(row)
        torch.cuda.synchronize()
    pair_ms = sum(r["ms"] for r in rows if r["name"] != fwd)
    best, by = bound_ms(*bnd["bwd_pair"])
    emit({"phase": "bwd_pair", "card": card, "of": [bwd_src, bwd_rel],
          "heads": heads, "feat": feat,
          "ms": pair_ms, "bound_ms": best, "bound_by": by,
          "bytes": bnd["bwd_pair"][0], "flops": bnd["bwd_pair"][1],
          "times_bound": pair_ms / best}, out_lines)
    return rows


def src_rows_errors(name, args, csr, kw):
    """``name`` (relgat_bwd_src or its bf16 variant) on the whole graph
    against its plain version in float64 on the out-edges of ``SRC_ROWS``
    random source rows: errors of dh, W and B on those rows, whose outputs
    depend on their out-edges alone and must equal the whole graph's bits.
    ``args`` are the kernel's inputs before the layout."""
    t = TRAIN
    full = KERNELS[name](*args, csr, **kw)
    src, dst, et = (a.cpu().numpy() for a in (csr.src, csr.dst, csr.etype))
    rows = np.random.default_rng(SEED + 13).choice(
        t["num_nodes"], SRC_ROWS, replace=False)
    keep = np.isin(src, rows)
    sub = build_graph(src[keep], dst[keep], et[keep], t["num_nodes"],
                      num_rel=t["num_rel"], csr=True, device=DEVICE).csr
    got = KERNELS[name](*args, sub, **kw)
    h, g, *rest = args
    want = PLAIN[name](h.double(), g.double(), *(a.double() for a in rest),
                       sub, **kw)
    r = torch.from_numpy(rows).to(DEVICE)
    errs = {}
    for key, a, b, c in zip(("dh", "w", "b"), got, want, full):
        check(torch.equal(a[r], c[r]), f"{name}: {key} of the chosen rows "
              "differs between the subset and the whole graph")
        errs[key] = {"max_rel_err": rel_err(a[r], b[r]),
                     "max_abs_err": abs_err(a[r], b[r])}
    return errs


def phase_kernels(graph, counts, default_counts, card, out_lines):
    """The kernels line's rows on ``TRAIN``'s graph at its widths (launches
    from phases train and train_bf16) and at the library's default widths
    (launches from phase train_default_width), and the yardsticks."""
    t, d = TRAIN, DEFAULT_WIDTH
    torch.cuda.empty_cache()
    csr = graph.csr
    n = graph.num_nodes
    rows = []
    widths = [(t["heads"], t["feat"], counts)]
    if default_counts is not None:
        widths.append((d["heads"], d["feat"], default_counts))
    for heads, feat, launches in widths:
        inputs = make_kernel_inputs(csr, n, heads, feat, t["num_rel"],
                                    SEED + 7)
        for bf16 in (False, True):
            rows += kernel_rows(inputs, bf16, launches, card, out_lines)
            torch.cuda.empty_cache()
        if heads == t["heads"]:
            h, g = inputs["h"], inputs["g"]
        del inputs
    # What this card reaches on plain traffic, beside the gathering kernels:
    # a copy of h, a gather of whole H*F rows of g (a quarter of the edges'
    # dst rows, read and written once each), and cuSPARSE's product of the
    # dst-CSR [N, N] (one weight per edge) with h, the forward's gather
    # pattern (its bytes: one h row per edge and the output once). Yardsticks
    # only: the port calls none of them.
    idx = csr.by_src_dst[: csr.num_edges // 4].long()
    copy_ms = cuda_ms(lambda: h.clone(), reps=10, warmup=2)
    gather_ms = cuda_ms(lambda: g.index_select(0, idx), reps=5, warmup=1)
    adj = torch.sparse_csr_tensor(
        csr.dst_ptr.long(), csr.src.long(),
        torch.ones(csr.num_edges, device=DEVICE), size=(n, n))
    spmm_ms = cuda_ms(lambda: torch.sparse.mm(adj, h), reps=5, warmup=1)
    hf = t["heads"] * t["feat"]
    emit({"phase": "yardsticks", "card": card,
          "copy_bytes_per_s": 2 * h.numel() * 4 / (copy_ms / 1e3),
          "row_gather_bytes_per_s": (2 * idx.numel() * g.shape[1] * 4
                                     / (gather_ms / 1e3)),
          "spmm_bytes_per_s": (4 * (csr.num_edges + n) * hf
                               / (spmm_ms / 1e3)),
          "copy_ms": copy_ms, "row_gather_ms": gather_ms,
          "spmm_ms": spmm_ms}, out_lines)
    check(all(r["max_rel_err"] <= REL_TOL for r in rows),
          "kernel parity at the train shapes failed")
    return rows


# ---------------------------------------------------------------------------
# Phase 7: a zipf graph of the train phase's size
# ---------------------------------------------------------------------------

def zipf_graph(rng):
    """``TRAIN``'s size with the in-degree on hubs: dst drawn with
    p ~ 1/rank, src and relations uniform (``bench.py``'s zipf class)."""
    t = TRAIN
    n, e = t["num_nodes"], t["num_edges"]
    p = 1.0 / np.arange(1, n + 1)
    src = rng.integers(0, n, e)
    dst = rng.choice(n, size=e, p=p / p.sum())
    et = rng.integers(0, t["num_rel"], e)
    return src, dst, et


def phase_zipf(card, uniform_step_ms, out_lines):
    """The train step and relgat_fwd on a zipf graph, where the forward's
    work plan splits the hub rows. Returns relgat_fwd's row of the kernels
    line for this graph: its launches are the zipf train steps', its error
    is against the float64 plain version on the in-edges of the heaviest
    and some random rows (a float64 [E, H, F] of the whole graph would not
    fit), and the whole graph's output must equal the kernel's on those
    rows bit for bit. It reads the work plan's size only where the layout
    has one, so it also times a package from before the plan."""
    t, z = TRAIN, ZIPF
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 11)
    src, dst, et = zipf_graph(rng)
    indeg = np.bincount(dst, minlength=t["num_nodes"])
    graph = build_graph(src, dst, et, t["num_nodes"], num_rel=t["num_rel"],
                        csr=True, device=DEVICE)
    csr = graph.csr
    n = graph.num_nodes
    plan = {k: getattr(csr, f"fwd_num_{k}", None)
            for k in ("items", "split", "parts")}
    print(f"zipf graph: max in-degree {int(indeg.max())}, "
          f"{plan['split']} rows split into {plan['parts']} chunks",
          flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    node_emb = torch.randn((n, t["in_dim"]), generator=gen, device=DEVICE)
    node_emb[t["num_nodes"]:] = 0.0  # padded rows, as pad_node_embeddings
    steps = z["warmup_steps"] + z["timed_steps"]
    batches = edge_batches(
        src, et, dst, rng.integers(0, t["num_edges"], (steps, t["batch"])))
    _, step, state, metrics, step_s, counts, _ = train_steps(
        node_emb, graph, batches, z["warmup_steps"])
    emit({"phase": "train_zipf", "card": card, "nodes": t["num_nodes"],
          "edges": t["num_edges"], "max_in_degree": int(indeg.max()),
          "rows_without_in_edges": int((indeg == 0).sum()),
          "split_rows": plan["split"], "work_items": plan["items"],
          "partial_slots": plan["parts"], "steps": steps,
          "timed_steps": z["timed_steps"], "step_ms": step_s * 1e3,
          "edge_messages_per_s": t["num_edges"] * t["layers"] / step_s,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "uniform_step_ms": uniform_step_ms,
          "step_vs_uniform": (step_s * 1e3 / uniform_step_ms
                              if uniform_step_ms else None),
          "loss": float(metrics["loss"]),
          "grad_norm": float(metrics["grad_norm"]), "launches": counts},
         out_lines)
    check_train(metrics, counts, expected_launches(False, t["layers"] * steps),
                "train_zipf")
    del state, step, node_emb, batches
    torch.cuda.empty_cache()

    inputs = make_kernel_inputs(csr, n, t["heads"], t["feat"],
                                t["num_rel"], SEED + 7)
    h, attn, bias = inputs["h"], inputs["attn"], inputs["bias"]
    kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    fwd, plain = KERNELS["relgat_fwd"], PLAIN["relgat_fwd"]
    by_degree = np.argsort(indeg, kind="stable")
    rows = np.concatenate([
        by_degree[-z["heavy_rows"]:],
        rng.choice(by_degree[:-z["heavy_rows"]], z["random_rows"],
                   replace=False)])
    keep = np.isin(dst, rows)
    sub = build_graph(src[keep], dst[keep], et[keep], t["num_nodes"],
                      num_rel=t["num_rel"], csr=True, device=DEVICE).csr
    got = fwd(h, attn, bias, sub, **kw)[0]
    want = plain(h.double(), attn.double(), bias.double(), sub, **kw)[0]
    err_rel, err_abs = rel_err(got, want), abs_err(got, want)
    del want
    rows_t = torch.from_numpy(rows).to(DEVICE)
    same = torch.equal(fwd(h, attn, bias, csr, **kw)[0][rows_t],
                       got[rows_t])
    ms = cuda_ms(lambda: fwd(h, attn, bias, csr, **kw), reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: plain(h, attn, bias, csr, **kw), reps=2)
    nbytes, flops = bounds(n, csr.num_edges, t["heads"], t["feat"],
                           t["num_rel"])["relgat_fwd"]
    best, by = bound_ms(nbytes, flops)
    source, replaces = KERNEL_SOURCES["relgat_fwd"]
    row = {
        "name": "relgat_fwd", "graph": "zipf", "route": "cuda",
        "source": source, "replaces": replaces,
        "launches": counts["relgat_fwd"], "max_abs_err": err_abs,
        "max_rel_err": err_rel, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": best, "bound_by": by, "library_ms": None,
        "reference": "float64", "parity_rows": int(rows.size),
        "parity_edges": int(keep.sum()), "bytes": nbytes, "flops": flops,
        "card": card,
        "row_gather_bytes": 4 * csr.num_edges * t["heads"] * t["feat"],
    }
    del got
    zipf_src_hubs(src, dst, et, inputs, card, out_lines)
    check(err_rel <= REL_TOL,
          f"relgat_fwd on the zipf graph: max relative error {err_rel}")
    check(same, "relgat_fwd gave other bits on the zipf graph's rows than "
                "on the same rows alone")
    return row


def zipf_src_hubs(src, dst, et, inputs, card, out_lines):
    """Diagnostic, no bar: relgat_bwd_src_bf16 on the zipf graph with src
    and dst swapped, so that its hubs are out-degree hubs, which the src
    pass walks one block per source row (``ROADMAP.md`` Queue 2)."""
    t = TRAIN
    sw = build_graph(dst, src, et, t["num_nodes"], num_rel=t["num_rel"],
                     csr=True, device=DEVICE).csr
    kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    h, g, attn, bias = inputs["h"], inputs["g"], inputs["attn"], inputs["bias"]
    rh, rg = h.to(torch.bfloat16), g.to(torch.bfloat16)
    out, m, l, b = KERNELS["relgat_fwd_bf16"](rh, attn, bias, sw, **kw)
    n = h.shape[0]
    s_dot = ((out - b[:, None]) * g).view(n, t["heads"], t["feat"]).sum(-1)
    args = (rh, rg, attn, m, l, s_dot, g.sum(1), sw)
    ms = cuda_ms(lambda: KERNELS["relgat_bwd_src_bf16"](*args, **kw), reps=5,
                 warmup=1)
    outdeg = np.bincount(dst, minlength=t["num_nodes"])
    print(f"zipf src hubs: relgat_bwd_src_bf16 {ms:.3f} ms, max out-degree "
          f"{int(outdeg.max())}", flush=True)
    emit({"phase": "zipf_src_hubs", "card": card,
          "kernel": "relgat_bwd_src_bf16", "ms": ms,
          "max_out_degree": int(outdeg.max())}, out_lines)


# ---------------------------------------------------------------------------
# Phase 8: the trainer through the CLI
# ---------------------------------------------------------------------------

def trainer_argv(save_dir):
    """``training_scripts/run-relgat-trainer-base-model.sh``'s flags, on a
    synthetic KG of ``TRAINER``'s size, one epoch, eval and save every
    ``TRAINER["every"]`` steps."""
    c = TRAINER
    return [
        "--synthetic", "--synthetic-nodes", str(c["nodes"]),
        "--synthetic-edges", str(c["triplets"]),
        "--synthetic-rels", str(c["num_rel"]),
        "--synthetic-dim", str(c["in_dim"]),
        "--synthetic-nn-pool", str(c["nn_pool"]), "--seed", str(SEED),
        "--architecture-name", "small", "--epochs", "1",
        "--batch-size", str(c["batch"]), "--num-neg", str(c["num_neg"]),
        "--gat-out-dim", str(c["feat"]), "--gat-num-layers", str(c["layers"]),
        "--heads", str(c["heads"]), "--scorer", "distmult",
        "--project-to-input-size", "--projection-layers", "2",
        "--projection-dropout", "0.3", "--dropout", "0.3", "--lr", "2e-5",
        "--lr-scheduler", "linear", "--weight-decay", "1e-4",
        "--use-self-adv-neg", "--self-adv-alpha", "1.0",
        "--relgat-weight", "1.0", "--pos-cosine-weight", "1.0",
        "--neg-cosine-weight", "1.0", "--mse-weight", "0.0",
        "--early-stop-patience", "10",
        "--eval-every-n-steps", str(c["every"]),
        "--save-every-n-steps", str(c["every"]),
        "--log-every-n-steps", str(c["every"]),
        "--max-checkpoints", str(c["max_checkpoints"]),
        "--save-dir", str(save_dir), "--use-pallas", "--device", DEVICE,
    ]


def logged(log, key):
    """Every value the trainer logged under ``key`` (its console JSON)."""
    return [float(v) for v in re.findall(rf'"{re.escape(key)}": ([^,\n]+)',
                                         log)]


def run_cli_leg(argv, name, out_dir):
    """``cli.main(argv)`` with its console captured (and written to
    ``out_dir``); returns (seconds, launch counts, console text)."""
    buf = io.StringIO()
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kern.launch_counts()
    if out_dir is not None:
        (out_dir / f"chip_smoke_trainer_{name}.log").write_text(buf.getvalue())
    return seconds, counts, buf.getvalue()


def saved_counts(ckpt_dir):
    """(step + nonfinite_steps, loop-state dispatch_step) of a checkpoint."""
    state = torch.load(ckpt_dir / "train-state.pt", map_location="cpu",
                       weights_only=True)
    loop = json.loads((ckpt_dir / "loop-state.json").read_text())
    return int(state["step"]) + int(state["nonfinite_steps"]), \
        loop["dispatch_step"], loop["best_metric_value"]


def check_leg(what, counts, log, steps, layers, bf16=False):
    evals = len(logged(log, "eval/mrr"))
    fwd, bwd_src, bwd_rel = VARIANTS[bf16]
    check(counts[bwd_src] == counts[bwd_rel] == layers * steps,
          f"{what}: backward launches {counts}, expected {layers * steps}")
    check(counts[fwd] == layers * (steps + evals),
          f"{what}: {fwd} launched {counts[fwd]} times, "
          f"expected {layers} x ({steps} steps + {evals} evals)")
    check(all(counts[k] == 0 for k in VARIANTS[not bf16]),
          f"{what}: the other variant's kernels launched: {counts}")
    losses = logged(log, "train/loss_step")
    check(bool(losses) and np.isfinite(losses[-1]),
          f"{what}: last logged loss {losses[-1:]}")
    return evals


def state_leaves(state):
    return (tree_leaves(state.params) + tree_leaves(state.opt_state.mu)
            + tree_leaves(state.opt_state.nu)
            + [state.opt_state.count, state.step, state.nonfinite_steps])


def resume_and_overhead(argv, work, steps, bs, card, out_lines, out_dir):
    """Through the Python API, on the same data and run config without
    eval: trainer A trains one epoch (timed per step) and saves; trainer B
    resumes from that directory; each takes one step on the same batch, and
    every parameter, Adam moment and counter must be bit-identical. Then a
    bare ``make_train_step`` loop over the first ``bare_steps`` batches of
    the same epoch, timed the same way."""
    c = TRAINER
    base = cli.build_run_config(cli.get_args(argv))
    run = dataclasses.replace(base, train=dataclasses.replace(
        base.train, eval_every_n_steps=None, save_every_n_steps=None,
        out_dir=str(work / "resume")))
    kg = generate_synthetic_kg(
        num_nodes=c["nodes"], num_edges=c["triplets"], num_rel=c["num_rel"],
        emb_dim=c["in_dim"], seed=SEED, nn_pool=c["nn_pool"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        a = RelGATTrainer(run, *kg, log_to_console=False, device=DEVICE)
        check(a.dataset.steps_per_epoch(bs) == steps,
              f"trainer has {a.dataset.steps_per_epoch(bs)} steps an epoch")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a._single_epoch(1, 1)
        torch.cuda.synchronize()
        trainer_step_ms = (time.perf_counter() - t0) / steps * 1e3
        ckpt = a._save_checkpoint("resume_check")
        a.storage.wait_for_writes()
        b = RelGATTrainer(run, *kg, log_to_console=False, device=DEVICE)
        check(b.maybe_resume(ckpt), "maybe_resume found nothing")
    batch = a._device_batch(next(iter(a.dataset.train_batches(bs))))
    a.state, _ = a._train_step(a.state, a.node_emb, a.graph, *batch)
    b.state, _ = b._train_step(b.state, b.node_emb, b.graph, *batch)
    identical = all(torch.equal(x, y) for x, y in
                    zip(state_leaves(a.state), state_leaves(b.state)))
    identical = identical and all(
        torch.equal(getattr(a.state.rng, k).get_state(),
                    getattr(b.state.rng, k).get_state())
        for k in ("host", "device"))
    graph = a.graph
    indeg = np.diff(graph.csr.dst_ptr.cpu().numpy())
    stats = {"max_in_degree": int(indeg.max()),
             "rows_without_in_edges": int((indeg[:graph.num_real_nodes]
                                           == 0).sum()),
             "split_rows": graph.csr.fwd_num_split}
    del a

    step = make_train_step(b.model_cfg, b.train_cfg, b.optimizer,
                           b.lr_schedule)
    batches = [b._device_batch(x) for x in itertools.islice(
        b.dataset.train_batches(bs), c["bare_steps"])]
    state = b.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in batches:
        state, _ = step(state, b.node_emb, b.graph, *x)
    torch.cuda.synchronize()
    bare_step_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    if out_dir is not None:
        (out_dir / "chip_smoke_trainer_resume.log").write_text(buf.getvalue())
    # The device's busy time per step against the trainer's step time: the
    # idle share is what the trainer's host loop leaves the card.
    profile_steps(step, state, b.node_emb, b.graph, batches[0][:3],
                  batches[0][3], trainer_step_ms,
                  step_matmul_flops(b.graph.num_nodes), card, out_lines,
                  out_dir, phase="trainer_profile")
    return identical, trainer_step_ms, bare_step_ms, stats


def serve_cli_leg(work, ckpt, out_dir):
    """The export CLI on the card on ``ckpt`` (trainer leg 1's final
    directory), over TRAINER's synthetic KG written as the reference's three
    files: its ``repr.npy`` must equal ``get_node_repr`` on the parameters
    of the directory's train state, bit for bit, through one forward launch
    a layer, and it prints ``top_k`` hits. Returns (the CLI's seconds, its
    launches, the whole leg's seconds, files included)."""
    c, s = TRAINER, SERVE
    t_leg = time.perf_counter()
    node2emb, rel2idx, triplets = generate_synthetic_kg(
        num_nodes=c["nodes"], num_edges=c["triplets"], num_rel=c["num_rel"],
        emb_dim=c["in_dim"], seed=SEED, nn_pool=c["nn_pool"])
    files = {name: work / name for name in
             ("nodes.pkl", "relations.json", "triplets.json", "repr.npy")}
    with open(files["nodes.pkl"], "wb") as f:
        pickle.dump(node2emb, f)
    files["relations.json"].write_text(json.dumps(rel2idx))
    files["triplets.json"].write_text(json.dumps([list(t) for t in triplets]))
    query_node, _, query_rel = triplets[0]
    argv = ["--checkpoint", str(ckpt),
            "--nodes-embeddings-path", str(files["nodes.pkl"]),
            "--relations-mapping", str(files["relations.json"]),
            "--relations-triplets", str(files["triplets.json"]),
            "--out", str(files["repr.npy"]), "--query-node", str(query_node),
            "--query-relation", query_rel, "--top-k", str(s["top_k"]),
            "--device", DEVICE]
    buf = io.StringIO()
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        export_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kern.launch_counts()
    printed = buf.getvalue()
    if out_dir is not None:
        (out_dir / "chip_smoke_serve_cli.log").write_text(printed)
    check_serve_launches(counts, 1, c["layers"], False, "export CLI")
    hits = json.loads(printed[printed.rindex('{\n  "query_node"'):])["top"]
    check(len(hits) == s["top_k"], f"the export CLI printed {len(hits)} hits")

    saved = torch.load(ckpt / "train-state.pt", map_location="cpu",
                       weights_only=True)["params"]
    cfg = ModelConfig.from_dict(json.loads((ckpt / "config.json").read_text()))
    with contextlib.redirect_stdout(io.StringIO()):
        data = RelGATData(node2emb, rel2idx, triplets, train_ratio=1.0,
                          csr=True, device=DEVICE)
    want = get_node_repr(tree_map(lambda t: t.to(DEVICE), saved),
                         dataclasses.replace(cfg, use_pallas=True),
                         torch.from_numpy(data.node_emb).to(DEVICE),
                         data.graph).cpu().numpy()
    got = np.load(files["repr.npy"])
    check(got.dtype == want.dtype and np.array_equal(got, want),
          "the export CLI's repr.npy differs from leg 1's final parameters")
    return seconds, counts, time.perf_counter() - t_leg


def phase_trainer(card, out_lines, out_dir):
    c = TRAINER
    bs, layers = c["batch"], c["layers"]
    steps = -(-int(c["train_ratio"] * c["triplets"]) // bs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
        work = Path(tmp)
        argv = trainer_argv(work / "cli")
        final = work / "cli" / "relgat_scorer-distmult_lrscheduler-linear"

        leg1_s, counts1, log1 = run_cli_leg(argv, "leg1", out_dir)
        evals1 = check_leg("trainer leg 1", counts1, log1, steps, layers)
        params1 = torch.load(final / "relgat-model.pt", map_location="cpu",
                             weights_only=True)
        files = sorted(p.name for p in final.iterdir())
        check(files == sorted([
            "config.json", "training-config.json", "relations-map.json",
            "loop-state.json", "relgat-model.pt", "train-state.pt"]),
            f"final checkpoint holds {files}")
        best = [p for p in final.parent.iterdir()
                if p.name.startswith("best_checkpoint_")]
        check(0 < len(best) <= c["max_checkpoints"],
              f"{len(best)} best checkpoints kept")
        ckpt_bytes = sum(p.stat().st_size for p in final.iterdir())
        done1, dispatch1, best1 = saved_counts(final)
        check(done1 == dispatch1 == steps,
              f"leg 1 saved step+nonfinite {done1}, dispatch {dispatch1}, "
              f"expected {steps}")
        check(best1 is not None and np.isfinite(best1),
              f"leg 1 best eval cosine {best1}")
        # Serve leg 1's final checkpoint before leg 2 trains on in it.
        cli_s, cli_counts, cli_leg_s = serve_cli_leg(work, final, out_dir)

        leg2_s, counts2, log2 = run_cli_leg(argv + ["--resume"], "leg2",
                                            out_dir)
        evals2 = check_leg("trainer leg 2", counts2, log2, steps, layers)
        resumed = f"Resumed from {final} at step" in log2
        check(resumed, "leg 2 did not resume from leg 1's final directory")
        done2, dispatch2, _ = saved_counts(final)
        check(done2 == dispatch2 == 2 * steps,
              f"leg 2 saved step+nonfinite {done2}, dispatch {dispatch2}, "
              f"expected {2 * steps}")
        peak = torch.cuda.max_memory_allocated()

        # Leg 3: the bf16 mode, a fresh directory, one epoch.
        torch.cuda.reset_peak_memory_stats()
        leg3_s, counts3, log3 = run_cli_leg(
            trainer_argv(work / "cli_bf16") + BF16_FLAGS, "leg3_bf16",
            out_dir)
        peak3 = torch.cuda.max_memory_allocated()
        evals3 = check_leg("trainer leg 3 (bf16)", counts3, log3, steps,
                           layers, bf16=True)
        final3 = work / "cli_bf16" / final.name
        done3, dispatch3, _ = saved_counts(final3)
        check(done3 == dispatch3 == steps,
              f"leg 3 saved step+nonfinite {done3}, dispatch {dispatch3}, "
              f"expected {steps}")
        saved_model = json.loads(
            (final3 / "training-config.json").read_text())["model"]
        check(all(saved_model[k] == v for k, v in BF16_MODE.items()),
              f"leg 3 training-config.json holds "
              f"{ {k: saved_model[k] for k in BF16_MODE} }")

        # Leg 4: leg 1 at several steps a call, a fresh directory, against
        # leg 1's final parameters (read before leg 2 overwrote them).
        s = c["steps_per_call"]
        leg4_s, counts4, log4 = run_cli_leg(
            trainer_argv(work / "cli_scan") + ["--steps-per-call", str(s)],
            "leg4_steps_per_call", out_dir)
        evals4 = check_leg("trainer leg 4 (steps per call)", counts4, log4,
                           -(-steps // s) * s, layers)
        final4 = work / "cli_scan" / final.name
        done4, dispatch4, _ = saved_counts(final4)
        params4 = torch.load(final4 / "relgat-model.pt", map_location="cpu",
                             weights_only=True)
        same4, diff4 = max_rel_diff(tree_leaves(params4), tree_leaves(params1))
        windows = [d for d in range(s, -(-steps // s) * s + 1, s)
                   if d % c["every"] < s]
        logs4 = len(logged(log4, "train/loss_step"))
        rates4 = logged(log4, "train/edges_per_sec")
        check(done4 == steps and dispatch4 == -(-steps // s) * s,
              f"leg 4 saved step+nonfinite {done4}, dispatch {dispatch4}")
        check(diff4 <= SAME_TOL,
              f"leg 4 ends {diff4} from leg 1's parameters")
        check(logs4 == len(windows) and evals4 == len(windows),
              f"leg 4 logged {logs4} times and evaluated {evals4} times, "
              f"expected the {len(windows)} windows {windows}")
        check(bool(rates4) and all(r > 0 for r in rates4),
              f"leg 4 logged train/edges_per_sec {rates4}")

        identical, trainer_ms, bare_ms, stats = resume_and_overhead(
            argv, work, steps, bs, card, out_lines, out_dir)
    ratio = trainer_ms / bare_ms
    emit({"phase": "trainer", "card": card,
          "nodes": c["nodes"], "triplets": c["triplets"],
          "in_dim": c["in_dim"], "num_rel": c["num_rel"],
          "steps_per_epoch": steps, **stats,
          "leg1_s": leg1_s, "leg2_s": leg2_s,
          "trainer_step_ms": trainer_ms, "bare_step_ms": bare_ms,
          "trainer_over_bare": ratio, "bare_steps": c["bare_steps"],
          "edges_per_sec_last_flush": [logged(log1, "train/edges_per_sec")[-1],
                                       logged(log2, "train/edges_per_sec")[-1]],
          "evals": [evals1, evals2],
          "launches": {"leg1": counts1, "leg2": counts2,
                       "leg3_bf16": counts3},
          "leg3_bf16": {"seconds": leg3_s, "evals": evals3,
                        "max_memory_allocated_bytes": peak3,
                        "last_loss": logged(log3, "train/loss_step")[-1],
                        "edges_per_sec_last_flush":
                            logged(log3, "train/edges_per_sec")[-1]},
          "leg4_steps_per_call": {
              "steps_per_call": c["steps_per_call"], "seconds": leg4_s,
              "evals": evals4, "log_lines": logs4, "windows": windows,
              "params_bit_identical_to_leg1": same4,
              "params_max_rel_diff_to_leg1": diff4,
              "edges_per_sec_last_flush": rates4[-1]},
          "launches_leg4": counts4,
          "checkpoint_bytes": ckpt_bytes,
          "max_memory_allocated_bytes": peak,
          "resumed_from_final": resumed,
          "resume_bit_identical": identical}, out_lines)
    check(identical, "one step after resume differs from the live step")
    check(ratio <= c["max_over_bare"],
          f"trainer step {trainer_ms:.3f} ms is {ratio:.3f}x the bare loop's "
          f"{bare_ms:.3f} ms (limit {c['max_over_bare']})")
    return {"cli_s": cli_s, "cli_leg_s": cli_leg_s,
            "cli_launches": cli_counts,
            "cli_nodes": c["nodes"], "cli_triplets": c["triplets"]}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 9: the halo route on a grid of ranks that share the card
# ---------------------------------------------------------------------------

# TRAIN's model on TRAIN's graph over grids of (data, graph) ranks, 2 steps
# each in fp32 and the bf16 mode, dropout off, TRAIN's lr 2e-5 without
# warm-up (a linear warm-up would leave the parameters where they start);
# the same steps on one device through the kernels are the reference. The
# ranks of each grid are processes of a process group of their own, which
# time-share the one card over gloo, named
# explicitly (NCCL refuses two ranks on one device), and gloo takes no
# CUDA tensor, so every collective goes through host memory. The split
# kernels are held to their plain versions on shard 0 of the G = 4 plan
# with attention dropout 0.2; a clustered graph (8 clusters, 90% of the
# edges inside them, ids in random order) gives halo_pair with and without
# the partitioner; and the CLI trains TRAINER's synthetic KG on two ranks
# with --mesh-graph 2 for one epoch, then resumes. Its batch (cli_batch,
# cli_num_neg negatives) keeps the epoch to 6 steps: on one card every
# exchange and gather goes through gloo on the host, about a second a
# step at 20k nodes.
HALO = dict(grids=((1, 2), (1, 4), (2, 2)), steps=2, shards=4,
            kernel_rate=0.2, kernel_seed=1234, clusters=8, intra=0.9,
            cli_ranks=2, cli_batch=4096, cli_num_neg=8, cli_numpy_ranks=[1],
            threads=2, timeout_s=900)
# The first step's gradient leaf by leaf (||a - b|| / ||b|| over each
# leaf), each step's loss and grad norm against the one-device run: the
# repo's parity bar in fp32; bf16 precision in the bf16 mode (as
# agree_bf16), where the shards' products and merges round h and g to bf16
# from fp32 values that differ in their last bits. The first step is the
# one whose inputs are the same on both sides (the same parameters and
# batch). A leaf's norm, not its largest element: an edge whose attention
# logit lies within rounding of 0 takes LeakyReLU's other derivative (1 or
# 0.2) on one side, a legitimate subgradient that moves one block of a few
# elements (halo_reading.py reads one at (1, 4)); max|a - b| / max|b| per
# leaf is reported beside it. The parameters after the steps are compared
# leaf by leaf and reported with the reading at their worst element.
HALO_TOL = {False: 1e-4, True: 1e-2}
GRID = None  # a halo rank's (data, graph), from its config.json
FINAL_DIR = "relgat_scorer-distmult_lrscheduler-linear"


class GradRecorder:
    """An optimizer that keeps the gradients of every update on the host,
    as it receives them (summed over the world on a grid), and then
    updates as ``optimizer`` does."""

    def __init__(self, optimizer):
        self.optimizer, self.grads = optimizer, []

    def init(self, params):
        return self.optimizer.init(params)

    def update(self, grads, state, params):
        self.grads.append([g.detach().cpu() for g in tree_leaves(grads)])
        return self.optimizer.update(grads, state, params)


def leaf_names(tree, prefix=""):
    """Each leaf's path (``layers[0].proj``), in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in leaf_names(t, f"{prefix}[{i}]")]
    return [prefix]


def halo_setup(bf16, device, **model):
    """TRAIN's model without dropout (``model`` overriding its config) at a
    constant lr, its state from the seed, and an optimizer that records
    each step's gradients."""
    t = TRAIN
    mcfg, tcfg = production_configs(**{
        "dropout": 0.0, "projection_dropout": 0.0,
        **(BF16_MODE if bf16 else {}), **model})
    tcfg = dataclasses.replace(tcfg, lr_scheduler="constant")
    total, _ = compute_total_and_warmup_steps(
        t["num_edges"], t["batch"], t["epochs"], None)
    sched = make_lr_schedule(tcfg.lr, "constant", total, 0)
    opt = GradRecorder(make_optimizer(tcfg, sched))
    state = create_train_state(
        init_model(mcfg, seed=SEED, device=device), opt, seed=SEED + 1)
    return mcfg, tcfg, opt, sched, state


def halo_steps(step, state, node_emb, graph, batches, snapshots=None):
    """The steps, each timed to a synchronize; (state, record). Given a
    list, ``snapshots`` gets the parameters on the host after each step."""
    weight = torch.ones(TRAIN["batch"], device=node_emb.device)
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launch_counts()
    losses, norms, ms = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, node_emb, graph, *batch, weight)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if snapshots is not None:
            snapshots.append([p.detach().cpu()
                              for p in tree_leaves(state.params)])
    return state, dict(losses=losses, grad_norms=norms, step_ms=ms,
                       peak_bytes=torch.cuda.max_memory_allocated(),
                       launches=kern.launch_counts())


def halo_inputs(steps):
    """TRAIN's seeded graph and embeddings, and ``steps`` batches."""
    src, dst, et, emb, picks = train_inputs(np.random.default_rng(SEED))
    return src, dst, et, emb, edge_batches(src, et, dst, picks[:steps])


def reference_steps():
    """Steps of the one-device runs: the most any grid takes."""
    return max(HALO["steps"], ROUTES["steps"])


def save_reference(path, init, grads, snapshots):
    """A one-device run for the ranks: its initial parameters, each step's
    gradients and the parameters after each step."""
    torch.save(dict(init=init, grads=grads, params_by_step=snapshots), path)


def halo_reference(work):
    """The one-device runs, fp32 and bf16; their initial parameters, each
    step's gradients and the parameters after each step go to ``work``
    for the ranks."""
    t = TRAIN
    src, dst, et, emb, batches = halo_inputs(reference_steps())
    graph = build_graph(src, dst, et, t["num_nodes"], num_rel=t["num_rel"],
                        csr=True, device=DEVICE)
    node_emb = torch.from_numpy(
        pad_node_embeddings(emb, graph.num_nodes)).to(DEVICE)
    refs = {}
    for bf16 in (False, True):
        mcfg, tcfg, opt, sched, state = halo_setup(bf16, DEVICE)
        init = [p.detach().cpu() for p in tree_leaves(state.params)]
        snapshots = []
        state, rec = halo_steps(make_train_step(mcfg, tcfg, opt, sched),
                                state, node_emb, graph, batches, snapshots)
        save_reference(work / f"ref_{int(bf16)}.pt", init, opt.grads,
                       snapshots)
        refs[bf16] = rec
        del state
    del graph, node_emb
    torch.cuda.empty_cache()
    return refs


def worst_param(names, leaves, ref, grads, tcfg):
    """The parameters against the one-device run, leaf by leaf, and the
    reading at the worst element: its initial value, its gradient at each
    step on both sides, the first step's input to Adam on both sides (the
    gradient plus weight decay times the initial value: the optimizer is
    "adam" with coupled decay), the leaf's largest reference gradient at
    each step, and both updates (parameter minus its initial value) in
    units of the lr."""
    by_leaf = [rel_err(a, b) for a, b in zip(leaves, ref["params"])]
    w = int(np.argmax(by_leaf))
    i = int((leaves[w].double() - ref["params"][w].double()).abs().argmax())

    def at(t):
        return float(t.reshape(-1)[i])

    lr, wd, p0 = tcfg.lr, tcfg.weight_decay, at(ref["init"][w])
    return dict(
        leaf=names[w], element=i, err=by_leaf[w], init=p0,
        update_lr=at(leaves[w] - ref["init"][w]) / lr,
        ref_update_lr=at(ref["params"][w] - ref["init"][w]) / lr,
        grad=[at(g[w]) for g in grads],
        ref_grad=[at(g[w]) for g in ref["grads"]],
        adam_input_step1=at(grads[0][w]) + wd * p0,
        ref_adam_input_step1=at(ref["grads"][0][w]) + wd * p0,
        ref_leaf_grad_max=[float(g[w].abs().max()) for g in ref["grads"]],
    )


def against_reference(state, opt, ref, grid, tcfg):
    """A grid's run against the same number of steps of the one-device run
    ``ref``: the first step's gradient leaf by leaf (and each step's worst
    leaf), the parameters' worst element, and whether every rank holds the
    same parameters."""
    from relgat_projector_tpu_torch.parallel.mesh import all_gather_cat

    steps = len(opt.grads)
    ref = dict(init=ref["init"], grads=ref["grads"][:steps],
               params=ref["params_by_step"][steps - 1])

    leaves = [p.detach().cpu() for p in tree_leaves(state.params)]
    names = leaf_names(state.params)
    sums = torch.stack([p.double().sum() for p in leaves])
    every = all_gather_cat(sums[None], grid.world_group, grid.backend)
    l2 = [[l2_rel_err(a, b) for a, b in zip(got, want)]
          for got, want in zip(opt.grads, ref["grads"])]
    peak = [[rel_err(a, b) for a, b in zip(got, want)]
            for got, want in zip(opt.grads, ref["grads"])]
    first, worst = int(np.argmax(l2[0])), int(np.argmax(peak[0]))
    return dict(
        grad_err=l2[0][first], grad_err_leaf=names[first],
        grad_err_by_step=[max(e) for e in l2],
        grad_max_rel=peak[0][worst], grad_max_rel_leaf=names[worst],
        grad_max_rel_by_step=[max(e) for e in peak],
        param=worst_param(names, leaves, ref, opt.grads, tcfg),
        ranks_agree=bool((every == every[0]).all()),
    )


def halo_rank(rank, world, port, work):
    """One rank of the grid ``GRID`` (a process group of its own), both
    modes; its records go to ``work/rank_DxG_R.json``."""
    from relgat_projector_tpu_torch.config import MeshConfig
    from relgat_projector_tpu_torch.parallel import (
        initialize_distributed,
        make_grid,
        place_graph,
    )
    from relgat_projector_tpu_torch.parallel.distributed import shutdown

    t = TRAIN
    data, shards = GRID
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                           device=DEVICE, timeout_s=HALO["timeout_s"])
    torch.set_num_threads(HALO["threads"])
    grid = make_grid(MeshConfig(data_axis=data, graph_axis=shards))
    src, dst, et, emb, batches = halo_inputs(HALO["steps"])
    hf = t["heads"] * t["feat"]
    base = build_graph(src, dst, et, t["num_nodes"], num_rel=t["num_rel"],
                       halo_shards=shards, halo_overlap=True, device=DEVICE)
    graph = place_graph(base, grid, t["num_rel"], csr=True)
    lo, hi = graph.halo.row_range
    node_emb = torch.from_numpy(np.ascontiguousarray(
        pad_node_embeddings(emb, graph.num_nodes)[lo:hi])).to(DEVICE)
    records = []
    for bf16 in (False, True):
        mcfg, tcfg, opt, sched, state = halo_setup(bf16, DEVICE)
        step = make_train_step(mcfg, tcfg, opt, sched, grid=grid)
        state, rec = halo_steps(step, state, node_emb, graph, batches)
        ref = torch.load(work / f"ref_{int(bf16)}.pt", weights_only=True)
        rec.update(against_reference(state, opt, ref, grid, tcfg))
        rec.update(
            grid=[data, shards], bf16=bf16, rank=rank,
            halo_pair=base.halo.halo_pair,
            rows_per_shard=base.halo.rows_per_shard,
            exchange_bytes_per_layer=(
                base.halo.exchange_bytes_per_device(4 * hf)),
            replication_bytes_per_layer=(
                base.halo.replication_bytes_per_device(4 * hf)),
            loc_edges=graph.halo.loc.num_edges,
            rem_edges=graph.halo.rem.num_edges,
            exchange_via=grid.exchange_via(node_emb.device),
        )
        records.append(rec)
        del state, step, opt, ref
        torch.cuda.empty_cache()
    (work / f"rank_{data}x{shards}_{rank}.json").write_text(
        json.dumps(records))
    shutdown()


def halo_cli_argv(save_dir, rank, world, port, mesh=None):
    """TRAINER's CLI flags with ``mesh`` (by default --mesh-graph of the
    world), a batch of cli_batch with cli_num_neg negatives (one epoch, the
    eval at its end, no periodic saves), joining the process group as rank
    ``rank``."""
    return trainer_argv(save_dir) + [
        "--batch-size", str(HALO["cli_batch"]),
        "--num-neg", str(HALO["cli_num_neg"]), "--eval-every-n-steps", "",
        "--save-every-n-steps", "0", "--log-every-n-steps", "10",
    ] + (mesh or ["--mesh-graph", str(world)]) + [
        "--distributed", "--num-processes",
        str(world), "--process-id", str(rank), "--coordinator-address",
        f"127.0.0.1:{port}",
    ]


def halo_cli_rank(rank, world, port, work):
    """``cli.main`` on this rank (the group joined on gloo first), counting
    its checkpoint writes and launches; the state a trainer built from the
    same argv resumes equals the CLI trainer's, and one step from each
    gives the same bits; then ``cli.main`` with --resume."""
    from relgat_projector_tpu_torch.parallel import initialize_distributed
    from relgat_projector_tpu_torch.parallel.distributed import shutdown
    from relgat_projector_tpu_torch.train.checkpoint import RelGATStorage

    if rank in HALO["cli_numpy_ranks"]:
        os.environ["RELGAT_NO_NATIVE"] = "1"
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                           device=DEVICE, timeout_s=HALO["timeout_s"])
    torch.set_num_threads(HALO["threads"])
    argv = halo_cli_argv(work / "cli", rank, world, port) + [
        "--partition-nodes"]
    writes, trainers = [], []
    save, train = RelGATStorage.save_checkpoint, RelGATTrainer.train

    def spy_save(self, subdir, *a, **kw):
        writes.append(subdir)
        return save(self, subdir, *a, **kw)

    def keep(self, *a, **kw):
        trainers.append(self)
        return train(self, *a, **kw)

    RelGATStorage.save_checkpoint = spy_save
    RelGATTrainer.train = keep
    rec = {"rank": rank, "native": load_native() is not None}
    for leg, extra in (("leg1", []), ("leg2", ["--resume"])):
        buf = io.StringIO()
        kern.reset_launch_counts()
        writes.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv + extra)
        torch.cuda.synchronize()
        cut = [line for line in buf.getvalue().splitlines()
               if line.startswith("Partitioned nodes for halo exchange")]
        rec[leg] = dict(seconds=time.perf_counter() - t0,
                        launches=kern.launch_counts(), writes=list(writes),
                        resumed="Resumed from" in buf.getvalue(),
                        log_bytes=len(buf.getvalue()), cut=cut)
        (work / f"cli_{leg}_rank{rank}.log").write_text(buf.getvalue())
        if leg == "leg1":
            live = trainers[-1]
            args = cli.get_args(argv)
            with contextlib.redirect_stdout(io.StringIO()):
                resumed = RelGATTrainer(
                    cli.build_run_config(args), *cli.load_kg(args),
                    log_to_console=False, device=DEVICE)
                resumed.maybe_resume()

            def state_leaves(st):
                return (tree_leaves(st.params) + tree_leaves(st.opt_state.mu)
                        + tree_leaves(st.opt_state.nu))

            rec["same_state"] = all(
                torch.equal(a, b) for a, b in
                zip(state_leaves(live.state), state_leaves(resumed.state)))
            batch = next(iter(live.dataset.train_batches(
                live.train_cfg.train_batch_size)))
            for tr in (live, resumed):
                tr.state, _ = tr._train_step(tr.state, tr.node_emb, tr.graph,
                                             *tr._device_batch(batch))
            rec["same_step"] = all(
                torch.equal(a, b) for a, b in
                zip(state_leaves(live.state), state_leaves(resumed.state)))
            rec["steps"] = int(live.global_step)
            del live, resumed, trainers[:]
            torch.cuda.empty_cache()
    (work / f"cli_rank_{rank}.json").write_text(json.dumps(rec))
    shutdown()


def spawn_ranks(mode, world, work, grid=None, runs=None):
    """``world`` processes of this script in rank mode ``mode`` (on
    ``grid`` for ``halo`` and ``routes``, the latter running ``runs``), on a
    free port; waits for all of them, each within the phase's time limit,
    and kills whatever is left. Fails if any rank fails."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    (work / "config.json").write_text(json.dumps(dict(
        TRAIN=TRAIN, TRAINER=TRAINER, HALO=HALO, ROUTES=ROUTES,
        PARITY=PARITY, DEVICE=DEVICE, SEED=SEED, GRID=grid, RUNS=runs)))
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank-mode",
             mode, "--rank", str(r), "--world", str(world), "--port",
             str(port), "--work", str(work)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=HALO["timeout_s"])[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tag = mode if grid is None else f"{mode}_{'x'.join(map(str, grid))}"
    for r, (p, log) in enumerate(zip(procs, logs)):
        (work / f"{tag}_rank{r}.out").write_text(log)
        check(p.returncode == 0,
              f"{mode} rank {r} exited {p.returncode}:\n{log[-4000:]}")


# Phase 9's grid_routes: the rest of the multi-device modes. Each entry of
# grids is a (data, graph, model) grid, a process group of its own, and the
# (route, mode) runs its ranks make in turn: 3 steps of TRAIN's model, lr
# 2e-5 constant, against the one-device run of the same mode at HALO_TOL
# (the one-device runs take 3 steps; the halo grids above, cut to 2 to
# keep the script near half its time limit, are held to the first 2).
# Modes: fp32, bf16, and "dropout": fp32 with TRAIN's dropout and an
# attention dropout of rel_attn_dropout, which on the replicated route
# draws one device's masks (the same seed on every shard, global edge ids).
# The gspmd route (plain, as in JAX) runs on PARITY's graph: at TRAIN's its
# E-sized plain tensors would not fit two ranks on the card. Then the CLI on
# two ranks, one epoch a leg: head TP and the replicated route; the kernels
# line's rows of a head-TP tile (8 heads) and of a replicated shard, whose
# source space is every row (at G = replicated_kernel_shards, where a
# float64 plain version fits the card beside it).
ROUTES = dict(
    grids=(((1, 1, 2), (("halo", "fp32"),)),
           ((1, 2, 2), (("halo", "fp32"), ("halo", "bf16"))),
           ((2, 2, 2), (("halo", "fp32"),)),
           ((1, 2, 1), (("replicated", "fp32"), ("replicated", "bf16"),
                        ("replicated", "dropout"), ("gspmd", "fp32"))),
           ((2, 2, 1), (("replicated", "fp32"),))),
    steps=3, rel_attn_dropout=0.2, replicated_kernel_shards=4,
    cli_legs=(("model", ["--mesh-model", "2"]),
              ("replicated", ["--mesh-propagate", "replicated",
                              "--mesh-graph", "2"])),
)
# The one-device runs: the halo grids' fp32 and bf16 (halo_reference), and
# these.
REF_FILES = {"fp32": "ref_0.pt", "bf16": "ref_1.pt",
             "dropout": "ref_dropout.pt", "gspmd": "ref_gspmd.pt"}
RUNS = None  # a routes rank's (route, mode) runs, from its config.json


def ref_key(route, mode):
    return "gspmd" if route == "gspmd" else mode


def route_model(route, mode):
    """(bf16, model overrides) of a run."""
    model = {}
    if mode == "dropout":
        model = dict(dropout=0.3, projection_dropout=0.3,
                     rel_attn_dropout=ROUTES["rel_attn_dropout"])
    if route == "gspmd":
        model["use_pallas"] = False
    return mode == "bf16", model


def route_inputs(route):
    """``((src, dst, et, emb, batches), nodes)`` of a route's runs: TRAIN's
    (``halo_inputs``), or for gspmd PARITY's graph (phase 3's) with seeded
    embeddings of TRAIN's width and batches of its size."""
    steps = reference_steps()
    if route != "gspmd":
        return halo_inputs(steps), TRAIN["num_nodes"]
    rng = np.random.default_rng(SEED)
    src, dst, et = parity_graph(rng)
    emb = rng.standard_normal((PARITY["num_nodes"], TRAIN["in_dim"]),
                              dtype=np.float32)
    picks = rng.integers(0, src.size, (steps, TRAIN["batch"]))
    return ((src, dst, et, emb, edge_batches(src, et, dst, picks)),
            PARITY["num_nodes"])


def routes_reference(work):
    """The one-device runs of the dropout mode and of the gspmd route's
    graph, to ``work`` for the ranks (fp32 and bf16 are halo_reference's)."""
    refs = {}
    for key, route, mode in (("dropout", "replicated", "dropout"),
                             ("gspmd", "gspmd", "fp32")):
        (src, dst, et, emb, batches), n = route_inputs(route)
        graph = build_graph(src, dst, et, n, num_rel=TRAIN["num_rel"],
                            csr=route != "gspmd", device=DEVICE)
        node_emb = torch.from_numpy(
            pad_node_embeddings(emb, graph.num_nodes)).to(DEVICE)
        bf16, model = route_model(route, mode)
        mcfg, tcfg, opt, sched, state = halo_setup(bf16, DEVICE, **model)
        init = [p.detach().cpu() for p in tree_leaves(state.params)]
        snapshots = []
        state, rec = halo_steps(make_train_step(mcfg, tcfg, opt, sched),
                                state, node_emb, graph, batches, snapshots)
        save_reference(work / REF_FILES[key], init, opt.grads, snapshots)
        refs[key] = rec
        del state, graph, node_emb
        torch.cuda.empty_cache()
    return refs


def route_traffic(route, base, graph, grid):
    """What a rank holds and sends a layer in the forward, in fp32 rows of
    TRAIN's width: its edges, the halo exchange over its graph line, and
    the join: the model line's heads (head TP), the graph line's rows
    (replicated; an all-gather, so a rank sends its block to each peer),
    or the merge's buffer (gspmd: the partial sum of [N, H*F + H + 1] and
    the max of [N, H], all-reduced)."""
    t = TRAIN
    hf = t["heads"] * t["feat"]
    if route == "halo":
        hg, tile = base.halo, 4 * hf // grid.model
        return dict(
            edges=graph.halo.loc.num_edges + graph.halo.rem.num_edges,
            halo_pair=hg.halo_pair, rows_per_shard=hg.rows_per_shard,
            exchange_bytes_per_layer=hg.exchange_bytes_per_device(tile),
            join_bytes_per_layer=(grid.model - 1) * hg.rows_per_shard * tile)
    if route == "replicated":
        shard = graph.edge_shard
        return dict(edges=shard.csr.num_edges, rows_per_shard=shard.rows,
                    exchange_bytes_per_layer=0,
                    join_bytes_per_layer=(grid.graph - 1) * shard.rows * 4
                    * hf)
    return dict(edges=int(graph.edge_shard.src.shape[0]),
                rows_per_shard=graph.num_nodes, exchange_bytes_per_layer=0,
                join_bytes_per_layer=4 * graph.num_nodes
                * (hf + 2 * t["heads"] + 1))


def routes_rank(rank, world, port, work):
    """One rank of the grid ``GRID`` (data, graph, model), a process group
    of its own, making the ``RUNS`` in turn; its records go to
    ``work/routes_DxGxM_R.json``."""
    from relgat_projector_tpu_torch.config import MeshConfig
    from relgat_projector_tpu_torch.parallel import (
        initialize_distributed,
        make_grid,
        place_graph,
    )
    from relgat_projector_tpu_torch.parallel.distributed import shutdown

    t = TRAIN
    data, shards, model = GRID
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                           device=DEVICE, timeout_s=HALO["timeout_s"])
    torch.set_num_threads(HALO["threads"])
    grid = make_grid(MeshConfig(data_axis=data, graph_axis=shards,
                                model_axis=model))
    records = []
    for route, mode in RUNS:
        (src, dst, et, emb, batches), n = route_inputs(route)
        batches = batches[:ROUTES["steps"]]
        base = build_graph(
            src, dst, et, n, num_rel=t["num_rel"],
            csr=route == "replicated", graph_shards=shards,
            halo_shards=shards if route == "halo" else 0, halo_overlap=True,
            device=DEVICE)
        graph = place_graph(base, grid, t["num_rel"],
                            csr=route != "gspmd")
        rows = pad_node_embeddings(emb, graph.num_nodes)
        if route == "halo":
            lo, hi = graph.halo.row_range
            rows = np.ascontiguousarray(rows[lo:hi])
        node_emb = torch.from_numpy(rows).to(DEVICE)
        del rows, emb
        bf16, over = route_model(route, mode)
        mcfg, tcfg, opt, sched, state = halo_setup(bf16, DEVICE, **over)
        step = make_train_step(mcfg, tcfg, opt, sched, grid=grid)
        state, rec = halo_steps(step, state, node_emb, graph, batches)
        ref = torch.load(work / REF_FILES[ref_key(route, mode)],
                         weights_only=True)
        rec.update(against_reference(state, opt, ref, grid, tcfg))
        rec.update(grid=list(GRID), route=route, mode=mode, rank=rank,
                   exchange_via=grid.exchange_via(node_emb.device),
                   **route_traffic(route, base, graph, grid))
        records.append(rec)
        del state, step, opt, ref, graph, base, node_emb
        torch.cuda.empty_cache()
    tag = "x".join(map(str, GRID))
    (work / f"routes_{tag}_{rank}.json").write_text(json.dumps(records))
    shutdown()


def routes_cli_rank(rank, world, port, work):
    """``cli.main`` on this rank for each of ``ROUTES``' CLI legs, one
    epoch each in a directory of its own, counting its checkpoint writes
    and launches."""
    from relgat_projector_tpu_torch.parallel import initialize_distributed
    from relgat_projector_tpu_torch.parallel.distributed import shutdown
    from relgat_projector_tpu_torch.train.checkpoint import RelGATStorage

    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                           device=DEVICE, timeout_s=HALO["timeout_s"])
    torch.set_num_threads(HALO["threads"])
    writes = []
    save = RelGATStorage.save_checkpoint

    def spy_save(self, subdir, *a, **kw):
        writes.append(subdir)
        return save(self, subdir, *a, **kw)

    RelGATStorage.save_checkpoint = spy_save
    rec = {"rank": rank}
    for leg, flags in ROUTES["cli_legs"]:
        argv = halo_cli_argv(work / f"cli_{leg}", rank, world, port,
                             mesh=flags)
        buf = io.StringIO()
        kern.reset_launch_counts()
        writes.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        torch.cuda.synchronize()
        rec[leg] = dict(seconds=time.perf_counter() - t0,
                        launches=kern.launch_counts(), writes=list(writes),
                        log_bytes=len(buf.getvalue()))
        (work / f"cli_{leg}_rank{rank}.log").write_text(buf.getvalue())
        torch.cuda.empty_cache()
    (work / f"routes_cli_rank_{rank}.json").write_text(json.dumps(rec))
    shutdown()


def route_launches(route, bf16, steps, layers):
    """Each kernel's launches a rank makes in ``steps`` train steps: both
    subsets on the halo route, one layout on the replicated route, no
    kernel on the gspmd route."""
    per = {"halo": 2, "replicated": 1, "gspmd": 0}[route] * layers * steps
    return expected_launches(bf16, per)


def route_kernel_rows(card, out_lines, launches):
    """The kernels line's rows of a head-TP tile (graph shard 0 of the
    G = 2 plan, model index 0: 8 heads, both subsets) and of shard 0 of
    the replicated route's plan at G = ``replicated_kernel_shards``
    (sources: every row). ``launches``: rank 0's counts of (1, 2, 2) and of
    (1, 2, 1)'s replicated runs."""
    t = TRAIN
    src, dst, et, _, _ = train_inputs(np.random.default_rng(SEED))
    plan = build_halo_graph(src, dst, et, t["num_nodes"], 2, overlap=True)
    parts = shard_edges(plan, 0, t["num_rel"], torch.device(DEVICE),
                        csr=True)
    heads = t["heads"] // 2
    rows = shard_kernel_rows(card, out_lines, [
        ("head TP G=2 M=2 tile (0, 0) local", parts["loc"].csr, heads),
        ("head TP G=2 M=2 tile (0, 0) remote", parts["rem"].csr, heads),
    ], launches["halo"], "rank 0 of grid (1, 2, 2), both subsets")
    del parts, plan
    g = ROUTES["replicated_kernel_shards"]
    base = build_graph(src, dst, et, t["num_nodes"], num_rel=t["num_rel"],
                       csr=True, graph_shards=g, device=DEVICE)
    csr = shard_csr_layout(base.edge_shard, 0, t["num_rel"],
                           torch.device(DEVICE))
    rows += shard_kernel_rows(
        card, out_lines, [(f"replicated G={g} shard 0", csr, t["heads"])],
        launches["replicated"], "rank 0 of grid (1, 2, 1), replicated")
    return rows


def grid_routes(card, out_lines, work, refs, out_dir):
    """The grids of ``ROUTES`` against the one-device runs, the CLI legs
    and the kernel rows; a ``grid_routes`` and a ``grid_routes_cli`` line.
    ``refs``: halo_reference's records, by bf16."""
    t, h = TRAIN, HALO
    layers = t["layers"]
    t0 = time.perf_counter()
    refs = {"fp32": refs[False], "bf16": refs[True],
            **routes_reference(work)}
    records = []
    for grid, runs in ROUTES["grids"]:
        world = int(np.prod(grid))
        spawn_ranks("routes", world, work, grid=grid, runs=runs)
        tag = "x".join(map(str, grid))
        records += [rec for r in range(world) for rec in
                    json.loads((work / f"routes_{tag}_{r}.json").read_text())]
    rows, launches = [], {"halo": {}, "replicated": {}}
    for rec in records:
        ref = refs[ref_key(rec["route"], rec["mode"])]
        rec["loss_err"] = max(abs(a - b) / abs(b) for a, b in
                              zip(rec["losses"], ref["losses"]))
        rec["grad_norm_err"] = max(abs(a - b) / abs(b) for a, b in
                                   zip(rec["grad_norms"], ref["grad_norms"]))
        rows.append({k: rec[k] for k in (
            "grid", "route", "mode", "rank", "step_ms", "peak_bytes",
            "edges", "rows_per_shard", "exchange_bytes_per_layer",
            "join_bytes_per_layer", "exchange_via", "grad_err",
            "grad_err_leaf", "grad_err_by_step", "grad_max_rel",
            "grad_max_rel_leaf", "loss_err", "grad_norm_err", "param")})
        if rec["route"] == "halo" and "halo_pair" in rec:
            rows[-1]["halo_pair"] = rec["halo_pair"]
    grid_s = time.perf_counter() - t0
    # The grids' line first, so that a failed check leaves its numbers.
    emit({"phase": "grid_routes", "card": card, "grids": rows,
          "reference": refs, "seconds": grid_s}, out_lines)
    for rec in records:
        bf16 = rec["mode"] == "bf16"
        what = (f"{rec['route']} grid {tuple(rec['grid'])} {rec['mode']} "
                f"rank {rec['rank']}")
        tol = HALO_TOL[bf16]
        for key in ("grad_err", "loss_err", "grad_norm_err"):
            check(rec[key] <= tol, f"{what}: {key} {rec[key]:.3e} > {tol}")
        check(rec["ranks_agree"], f"{what}: ranks hold other parameters")
        want = route_launches(rec["route"], bf16, ROUTES["steps"], layers)
        check(rec["launches"] == want,
              f"{what}: launches {rec['launches']}, expected {want}")
        if rec["rank"] == 0 and rec["mode"] in ("fp32", "bf16"):
            if tuple(rec["grid"]) == (1, 2, 2):
                launches["halo"][bf16] = rec["launches"]
            if (tuple(rec["grid"]) == (1, 2, 1)
                    and rec["route"] == "replicated"):
                launches["replicated"][bf16] = rec["launches"]

    t1 = time.perf_counter()
    spawn_ranks("routes_cli", h["cli_ranks"], work)
    cli_recs = [json.loads((work / f"routes_cli_rank_{r}.json").read_text())
                for r in range(h["cli_ranks"])]
    steps = -(-int(TRAINER["train_ratio"] * TRAINER["triplets"])
              // h["cli_batch"])
    cli_rec = dict(ranks=h["cli_ranks"], batch=h["cli_batch"],
                   steps_per_epoch=steps)
    for leg, flags in ROUTES["cli_legs"]:
        subsets = 2 if leg == "model" else 1
        want = expected_launches(False, subsets * layers * steps)
        # one forward a layer a step and for the eval
        want["relgat_fwd"] = subsets * layers * (steps + 1)
        for rec in cli_recs:
            primary = rec["rank"] == 0
            check(rec[leg]["writes"] == ([FINAL_DIR] if primary else []),
                  f"cli {leg} rank {rec['rank']} wrote {rec[leg]['writes']}")
            check(rec[leg]["launches"] == want,
                  f"cli {leg} rank {rec['rank']} launches "
                  f"{rec[leg]['launches']}, expected {want}")
        done, dispatch, _ = saved_counts(work / f"cli_{leg}" / FINAL_DIR)
        check(done == dispatch == steps,
              f"the CLI {leg} leg saved step {done}, dispatch {dispatch}")
        cli_rec[leg] = dict(flags=flags, saved_step=done,
                            seconds=[r[leg]["seconds"] for r in cli_recs])
    cli_rec["seconds"] = time.perf_counter() - t1
    if out_dir is not None:
        for p in work.glob("routes*.out"):
            (out_dir / f"chip_smoke_{p.name}").write_text(p.read_text())
    emit({"phase": "grid_routes_cli", "card": card, **cli_rec}, out_lines)
    kernel_rows = route_kernel_rows(card, out_lines, launches)
    return kernel_rows, dict(grid_s=grid_s, cli=cli_rec,
                             seconds=time.perf_counter() - t0)


def clustered_graph(rng):
    """TRAIN's size in ``clusters`` clusters, a node's cluster drawn at
    random (so ids say nothing of it): each edge's dst uniform, its src in
    dst's cluster with probability ``intra``, else uniform."""
    t, h = TRAIN, HALO
    n, e = t["num_nodes"], t["num_edges"]
    cluster = rng.integers(0, h["clusters"], n)
    dst = rng.integers(0, n, e)
    src = rng.integers(0, n, e)
    inside = rng.random(e) < h["intra"]
    for c in range(h["clusters"]):
        members = np.flatnonzero(cluster == c)
        sel = inside & (cluster[dst] == c)
        src[sel] = members[rng.integers(0, members.size, int(sel.sum()))]
    return src, dst, rng.integers(0, t["num_rel"], e)


def halo_clustered():
    """halo_pair and the bytes each rank sends a layer (fp32 rows of
    TRAIN's width) on the clustered graph at G = 4, with and without the
    partitioner's relabeling, on its native (C++) route and on its NumPy
    route: the native library must load here, and the native cut must meet
    the JAX package's bar against the NumPy one (``tests/
    test_partition.py``: ``cut_native <= 1.3 * cut_numpy + 0.02``). The
    top-level fields are the native route's, the default."""
    t = TRAIN
    n, shards = t["num_nodes"], HALO["shards"]
    feat_bytes = 4 * t["heads"] * t["feat"]
    src, dst, et = clustered_graph(np.random.default_rng(SEED + 3))
    t0 = time.perf_counter()
    check(load_native() is not None,
          "the native partition library did not build or load")
    native_load_s = time.perf_counter() - t0  # the g++ build included

    def traffic(s, d):
        hg = build_halo_graph(s, d, et, n, shards, overlap=True)
        return dict(
            halo_pair=hg.halo_pair,
            exchange_bytes_per_layer=hg.exchange_bytes_per_device(feat_bytes),
            remote_edges=int(hg.rem_mask.sum()),
        )

    routes = {}
    for route in ("native", "numpy"):
        if route == "numpy":
            os.environ["RELGAT_NO_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            perm, stats = partition_node_permutation(
                src, dst, n, shards, halo_rows_per_shard(n, shards))
            seconds = time.perf_counter() - t0
        finally:
            os.environ.pop("RELGAT_NO_NATIVE", None)
        routes[route] = dict(partition_route=route, partition_s=seconds,
                             perm=perm, **stats,
                             partitioned=traffic(perm[src], perm[dst]))
    rec = {k: v for k, v in routes["native"].items() if k != "perm"}
    rec["native_load_s"] = native_load_s
    rec["ids_as_drawn"] = traffic(src, dst)
    rec["numpy_route"] = {k: v for k, v in routes["numpy"].items()
                          if k != "perm"}
    rec["routes_differ"] = not np.array_equal(routes["native"]["perm"],
                                              routes["numpy"]["perm"])
    cut_native = rec["edge_cut_after"]
    cut_numpy = rec["numpy_route"]["edge_cut_after"]
    rec["cut_bar"] = 1.3 * cut_numpy + 0.02
    for r in (rec, rec["numpy_route"]):
        check(r["partitioned"]["halo_pair"]
              < rec["ids_as_drawn"]["halo_pair"],
              f"the partitioner ({r['partition_route']} route) did not cut "
              f"halo_pair: {rec}")
    check(cut_native <= rec["cut_bar"],
          f"native edge cut {cut_native} above 1.3 x the NumPy route's "
          f"{cut_numpy} + 0.02")
    return rec


def halo_kernel_rows(card, out_lines, launches):
    """The kernels line's rows of the split kernels on shard 0 of the
    G = 4 plan (local and remote subsets: source rows apart from the
    destination rows, canonical edge ids); ``launches``: rank 0's counts in
    the (1, 4) run, both subsets."""
    t, h = TRAIN, HALO
    src, dst, et, _, _ = train_inputs(np.random.default_rng(SEED))
    plan = build_halo_graph(src, dst, et, t["num_nodes"], h["shards"],
                            overlap=True)
    parts = shard_edges(plan, 0, t["num_rel"], torch.device(DEVICE),
                        csr=True)
    label = f"halo G={h['shards']} shard 0"
    return shard_kernel_rows(card, out_lines, [
        (f"{label} local", parts["loc"].csr, t["heads"]),
        (f"{label} remote", parts["rem"].csr, t["heads"]),
    ], launches, "rank 0 of grid (1, 4), both subsets")


def shard_kernel_rows(card, out_lines, cases, launches, launches_of):
    """Rows of the kernels line for each ``(label, csr, heads)`` of
    ``cases`` (TRAIN's feature width; source rows ``csr.num_src`` apart
    from the destination rows), fp32 and bf16, attention dropout
    ``kernel_rate``: each kernel against its plain version in float64, the
    forward and src pass giving the same bits twice, timed beside its
    bound and the row-gather floor over the layout's edges. ``launches``:
    the counts of the main path's run named by ``launches_of``."""
    t, h = TRAIN, HALO
    feat, num_rel = t["feat"], t["num_rel"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    kw = dict(seed=h["kernel_seed"], rate=h["kernel_rate"],
              negative_slope=0.2, eps=1e-16)
    out_rows = []
    for label, csr, heads in cases:
        hf = heads * feat
        rows = csr.num_nodes
        hs = torch.randn((csr.num_src, hf), generator=gen, device=DEVICE)
        g = torch.randn((rows, hf), generator=gen, device=DEVICE)
        attn = torch.randn((heads, num_rel, feat), generator=gen,
                           device=DEVICE) * 0.3
        bias = torch.randn((num_rel,), generator=gen, device=DEVICE) * 0.1
        for bf16 in (False, True):
            fwd, bwd_src, bwd_rel = VARIANTS[bf16]
            rh = hs.to(torch.bfloat16) if bf16 else hs
            rg = g.to(torch.bfloat16) if bf16 else g
            res = KERNELS[fwd](rh, attn, bias, csr, **kw)
            same = all(torch.equal(a, b) for a, b in
                       zip(res, KERNELS[fwd](rh, attn, bias, csr, **kw)))
            out, m, l, b = res
            s_dot = ((out - b[:, None]) * g).view(rows, heads, feat).sum(-1)
            gsum = g.sum(1)
            back = KERNELS[bwd_src](rh, rg, attn, m, l, s_dot, gsum, csr, **kw)
            same = same and all(torch.equal(a, c) for a, c in zip(
                back, KERNELS[bwd_src](rh, rg, attn, m, l, s_dot, gsum, csr,
                                       **kw)))
            check(same, f"{fwd} or {bwd_src} gave other bits in a second "
                        f"call on {label}")
            rel = KERNELS[bwd_rel](rh, back[1], back[2])
            errs = {}
            want = PLAIN[fwd](*(x.double() for x in (rh, attn, bias)), csr,
                              **kw)
            fin = torch.isfinite(want[1])
            check(torch.equal(fin, torch.isfinite(m)),
                  f"{fwd}: rows without edges differ on {label}")
            errs[fwd] = [(abs_err(a, c), rel_err(a, c)) for a, c in
                         zip((out, m[fin], l, b), (want[0], want[1][fin],
                                                   want[2], want[3]))]
            del want
            want = PLAIN[bwd_src](*(x.double() for x in
                                    (rh, rg, attn, m, l, s_dot, gsum)),
                                  csr, **kw)
            errs[bwd_src] = [(abs_err(a, c), rel_err(a, c))
                             for a, c in zip(back, want)]
            del want
            want = PLAIN[bwd_rel](rh.double(), back[1].double(),
                                  back[2].double())
            errs[bwd_rel] = [(abs_err(a, c), rel_err(a, c))
                             for a, c in zip(rel, want)]
            del want
            torch.cuda.empty_cache()
            calls = {
                fwd: lambda f: f(rh, attn, bias, csr, **kw),
                bwd_src: lambda f: f(rh, rg, attn, m, l, s_dot, gsum, csr,
                                     **kw),
                bwd_rel: lambda f: f(rh, back[1], back[2]),
            }
            library = ({} if bf16 else {bwd_rel: lambda: torch.einsum(
                "nhr,nhf->hrf", back[1], hs.view(-1, heads, feat))})
            row_bytes = rh.element_size()
            bnd = bounds(hs.shape[0], csr.num_edges, heads, feat, num_rel,
                         row_bytes=row_bytes, n_dst=rows, dropout=True)
            for name, kind in zip(VARIANTS[bf16], VARIANTS[False]):
                source, replaces = KERNEL_SOURCES[name]
                best, by = bound_ms(*bnd[kind])
                row = {
                    "name": name, "graph": label, "heads": heads,
                    "feat": feat, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": launches[bf16][name],
                    "launches_of": launches_of,
                    "max_abs_err": max(e[0] for e in errs[name]),
                    "max_rel_err": max(e[1] for e in errs[name]),
                    "ms": cuda_ms(lambda: calls[name](KERNELS[name]),
                                  reps=10, warmup=2),
                    "plain_ms": cuda_ms(lambda: calls[name](PLAIN[name]),
                                        reps=2),
                    "bound_ms": best, "bound_by": by,
                    "library_ms": (cuda_ms(library[name], reps=10, warmup=2)
                                   if name in library else None),
                    "num_src": int(hs.shape[0]), "num_dst": rows,
                    "edges": csr.num_edges, "bytes": bnd[kind][0],
                    "flops": bnd[kind][1], "reference": "float64",
                    "card": card,
                }
                if name != bwd_rel:
                    row["same_bits_twice"] = same
                    row["row_gather_bytes"] = (row_bytes * csr.num_edges
                                               * hf)
                    row["row_gather_floor_ms"] = (row["row_gather_bytes"]
                                                  / PEAK_BYTES_PER_S * 1e3)
                emit({"phase": "kernel", **row}, out_lines)
                out_rows.append(row)
            del res, back, rel, calls, library
            torch.cuda.empty_cache()
        del hs, g
    check(all(r["max_rel_err"] <= REL_TOL for r in out_rows),
          f"shard kernel parity failed ({launches_of})")
    return out_rows


def phase_halo(card, out_lines, out_dir):
    """The grids against the one-device run, the clustered graph, the CLI
    on two ranks, and the split kernels' rows; one ``halo`` line."""
    t, h = TRAIN, HALO
    layers = t["layers"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_halo_") as tmp:
        work = Path(tmp)
        refs = halo_reference(work)
        records = []
        for data, shards in h["grids"]:
            spawn_ranks("halo", data * shards, work, grid=(data, shards))
            records += [rec for r in range(data * shards) for rec in
                        json.loads((work / f"rank_{data}x{shards}_{r}.json")
                                   .read_text())]
        grids = []
        launches = {}
        for rec in records:
            ref = refs[rec["bf16"]]
            rec["loss_err"] = max(abs(a - b) / abs(b) for a, b in
                                  zip(rec["losses"], ref["losses"]))
            rec["grad_norm_err"] = max(abs(a - b) / abs(b) for a, b in
                                       zip(rec["grad_norms"],
                                           ref["grad_norms"]))
            grids.append({k: rec[k] for k in (
                "grid", "bf16", "rank", "step_ms", "peak_bytes", "halo_pair",
                "rows_per_shard", "loc_edges", "rem_edges",
                "exchange_bytes_per_layer", "replication_bytes_per_layer",
                "exchange_via", "grad_err", "grad_err_leaf",
                "grad_err_by_step", "grad_max_rel", "grad_max_rel_leaf",
                "grad_max_rel_by_step", "loss_err", "grad_norm_err",
                "param")})
        # The grids' line first, so that a failed check leaves its numbers.
        emit({"phase": "halo_grids", "card": card, "grids": grids,
              "reference": {("bf16" if k else "fp32"): v
                            for k, v in refs.items()},
              "seconds": time.perf_counter() - t0}, out_lines)
        for rec in records:
            bf16, (data, shards) = rec["bf16"], rec["grid"]
            what = f"halo grid ({data}, {shards}) {'bf16' if bf16 else 'fp32'}"
            tol = HALO_TOL[bf16]
            for key in ("grad_err", "loss_err", "grad_norm_err"):
                check(rec[key] <= tol, f"{what} rank {rec['rank']}: {key} "
                                       f"{rec[key]:.3e} > {tol}")
            check(rec["ranks_agree"], f"{what}: ranks hold other parameters")
            per = 2 * layers * h["steps"]
            check(expected_launches(bf16, per) == rec["launches"],
                  f"{what} rank {rec['rank']} launches {rec['launches']}, "
                  f"expected {per} of each {'bf16' if bf16 else 'fp32'} "
                  "kernel")
            if (data, shards) == (1, h["shards"]) and rec["rank"] == 0:
                launches[bf16] = rec["launches"]
        grid_s = time.perf_counter() - t0
        clustered = halo_clustered()

        t1 = time.perf_counter()
        spawn_ranks("cli", h["cli_ranks"], work)
        cli_recs = [json.loads((work / f"cli_rank_{r}.json").read_text())
                    for r in range(h["cli_ranks"])]
        final = work / "cli" / FINAL_DIR
        steps = -(-int(TRAINER["train_ratio"] * TRAINER["triplets"])
                  // h["cli_batch"])
        for rec in cli_recs:
            primary = rec["rank"] == 0
            for leg in ("leg1", "leg2"):
                want = [FINAL_DIR] if primary else []
                check(rec[leg]["writes"] == want,
                      f"cli rank {rec['rank']} {leg} wrote {rec[leg]['writes']}")
                # one forward a layer a step and for the eval, both subsets
                fwd = 2 * layers * (steps + 1)
                want_counts = expected_launches(False, 2 * layers * steps)
                want_counts["relgat_fwd"] = fwd
                check(rec[leg]["launches"] == want_counts,
                      f"cli rank {rec['rank']} {leg} launches "
                      f"{rec[leg]['launches']}, expected {want_counts}")
            check(rec["leg2"]["resumed"] == primary,
                  f"cli rank {rec['rank']}: 'Resumed from' printed "
                  f"{rec['leg2']['resumed']}")
            check(rec["same_state"] and rec["same_step"],
                  f"cli rank {rec['rank']}: the resumed state or step "
                  "differs from the live one")
            check(rec["steps"] == steps, f"cli rank {rec['rank']} took "
                                         f"{rec['steps']} steps, not {steps}")
            numpy_rank = rec["rank"] in h["cli_numpy_ranks"]
            check(rec["native"] != numpy_rank,
                  f"cli rank {rec['rank']}: native library loaded "
                  f"{rec['native']}")
            for leg in ("leg1", "leg2"):
                check(len(rec[leg]["cut"]) == 1
                      and rec[leg]["cut"] == cli_recs[0]["leg1"]["cut"],
                      f"cli rank {rec['rank']} {leg} logged the cut "
                      f"{rec[leg]['cut']}, rank 0 "
                      f"{cli_recs[0]['leg1']['cut']}")
        done, dispatch, _ = saved_counts(final)
        check(done == dispatch == 2 * steps,
              f"the resumed CLI run saved step {done}, dispatch {dispatch}")
        cli_rec = dict(ranks=h["cli_ranks"], batch=h["cli_batch"],
                       steps_per_epoch=steps, partition_nodes=True,
                       numpy_ranks=h["cli_numpy_ranks"],
                       cut=cli_recs[0]["leg1"]["cut"],
                       leg1_s=[r["leg1"]["seconds"] for r in cli_recs],
                       leg2_s=[r["leg2"]["seconds"] for r in cli_recs],
                       resume_bit_identical=True, saved_step=done,
                       seconds=time.perf_counter() - t1)
        if out_dir is not None:
            for p in work.glob("*.out"):
                (out_dir / f"chip_smoke_halo_{p.name}").write_text(
                    p.read_text())
        kernel_rows = halo_kernel_rows(card, out_lines, launches)
        route_rows, routes = grid_routes(card, out_lines, work, refs,
                                         out_dir)
        kernel_rows += route_rows
    emit({"phase": "halo", "card": card,
          "ranks": "processes time-sharing one card over gloo; step_ms is "
                   "not a scaling number",
          "grids": [{k: g[k] for k in ("grid", "bf16", "rank", "step_ms",
                                       "peak_bytes", "halo_pair",
                                       "exchange_bytes_per_layer",
                                       "exchange_via", "grad_err",
                                       "loss_err", "grad_norm_err")}
                    for g in grids],
          "grid_s": grid_s, "clustered": clustered, "cli": cli_rec,
          "routes": routes, "seconds": time.perf_counter() - t0}, out_lines)
    return kernel_rows


def rank_main(args) -> int:
    """One rank of phase 9 (``--rank-mode halo|cli``), started by
    ``spawn_ranks`` with the phase's settings in ``WORK/config.json``."""
    work = Path(args.work)
    globals().update(json.loads((work / "config.json").read_text()))
    run = {"halo": halo_rank, "cli": halo_cli_rank, "routes": routes_rank,
           "routes_cli": routes_cli_rank}[args.rank_mode]
    run(int(args.rank), int(args.world), int(args.port), work)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the result lines and a trace")
    ap.add_argument("--zipf-only", action="store_true",
                    help="build the kernels and run phase 7 alone; a copy of "
                         "this file run from another checkout times that "
                         "checkout's package on the zipf graph")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels and time them at TRAIN's widths "
                         "on its graph (phase 6 alone, launches null); a "
                         "copy of this file run from another checkout times "
                         "that checkout's kernels")
    for flag in ("--rank-mode", "--rank", "--world", "--port", "--work"):
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_mode is not None:
        return rank_main(args)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    out_lines: list = []
    print(f"device: {torch.cuda.get_device_name(0)} ({card}), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line:
                print(f"build {name}: {line.strip()}")
    emit({"phase": "build", "build_s": build_s, "card": card}, out_lines)

    if args.zipf_only:
        kernels = [phase_zipf(card, None, out_lines)]
    elif args.kernels_only:
        src, dst, et, _, _ = train_inputs(np.random.default_rng(SEED))
        graph = build_graph(src, dst, et, TRAIN["num_nodes"],
                            num_rel=TRAIN["num_rel"], csr=True, device=DEVICE)
        # No main path runs here, so no launches were counted.
        kernels = phase_kernels(graph, {k: None for k in KERNELS}, None,
                                card, out_lines)
    else:
        worst = phase_parity(card, out_lines)
        worst = max(worst, phase_parity_wide(card, out_lines))
        phase_agree(card, out_lines)
        phase_agree_bf16(card, out_lines)
        (counts, graph, step_ms, node_emb, batches, first_loss, params,
         mcfg) = phase_train(card, out_lines, args.out)
        t0 = time.perf_counter()
        serve = phase_serve(card, params, mcfg, graph, node_emb)
        serve["phase_s"] = time.perf_counter() - t0
        del params
        counts_bf16, bf16_record = phase_train_bf16(
            card, out_lines, args.out, graph, node_emb, batches, first_loss)
        default_counts = phase_train_default(card, out_lines, graph,
                                             node_emb, batches)
        t0 = time.perf_counter()
        phase_remat(card, out_lines, graph, node_emb, batches)
        phase_param_bf16(card, out_lines, graph, node_emb, batches,
                         bf16_record)
        phase_train_fp16(card, out_lines, graph, node_emb, batches,
                         first_loss)
        phase_param_fp16(card, out_lines)
        phase_edges_8m(card, out_lines, graph, node_emb)
        emit({"phase": "single_device_settings", "card": card,
              "seconds": time.perf_counter() - t0}, out_lines)
        del node_emb, batches
        launches = {k: counts[k] for k in VARIANTS[False]}
        launches.update({k: counts_bf16[k] for k in VARIANTS[True]})
        kernels = phase_kernels(graph, launches, default_counts, card,
                                out_lines)
        del graph
        kernels.append(phase_zipf(card, step_ms, out_lines))
        serve.update(phase_trainer(card, out_lines, args.out))
        kernels += phase_halo(card, out_lines, args.out)
        emit({"phase": "serve", "card": card, **serve}, out_lines)
        emit({"parity_max_rel_err": worst, "card": card}, out_lines)
    emit({"kernels": kernels}, out_lines)
    if args.out is not None:
        (args.out / "chip_smoke.jsonl").write_text("\n".join(out_lines) + "\n")
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.zipf_only or args.kernels_only:
        # A timing run: it checks no main path, so it claims no "ok".
        print(json.dumps({"timing_only": True, "device": device}))
    else:
        print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
