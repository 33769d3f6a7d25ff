"""Boundary-only halo exchange: node-sharded message passing over the grid.

Port of ``relgat_projector_tpu/parallel/halo.py``. Node features live
sharded over the ``graph`` axis end to end: the rank at graph index ``g``
owns the contiguous destination rows ``[g * rows, (g + 1) * rows)`` and the
edges into them. Per layer:

1. each rank gathers, from its own rows, the rows each peer's edges read
   (the host-built ``send_idx``), and one ``all_to_all`` over its graph line
   delivers to each rank its boundary (halo) rows: ``G * halo_pair`` rows,
   which for a partitioned or clustered graph is the boundary, not N;
2. each rank runs the propagate over its own rows and the halo buffer;
3. destination rows are owned exclusively, so the outputs need no
   reduction.

The exchange is an autograd Function whose backward is the reverse exchange,
and the gather before it scatters the returned cotangents back into the
owner's rows (``index_select``'s backward), so the backward ships
boundary-sized cotangents too.

With ``overlap`` (the default, ``ModelConfig.halo_overlap``) each shard's
edges are split on the host into LOCAL-source edges, which read the shard's
own rows, and REMOTE-source edges, which read the halo buffer; the two
subsets' partials merge flash-style (``ops/propagate.py``
``OverlappedPropagate``, or ``relgat_propagate_partial`` and
``merge_propagate_partials`` on the plain route), so the local subset has no
data dependence on the exchange. Each subset's edges carry their canonical
per-shard ids (their positions in the shard's dst-sorted edge list), so
dropout masks are those of the unsplit layout. Without it the propagate
reads the concatenation ``[own rows ++ halo buffer]`` through one layout.

The plan (``build_halo_graph``) is the JAX package's, array for array, in
numpy on the host; ``place_halo_graph`` turns one shard of it into the
rank's ``HaloShard``: index tensors on its device, and the kernels' CSR
layouts (``data/csr.py``, source space apart from the destination rows)
when the kernels run.

Head tensor parallelism (a ``model`` axis of ``M``): the rank at
``(g, m)`` holds the tile ``[rows, H/M, F]`` of ``h`` and the attention
bank's heads ``[m H/M, (m+1) H/M)`` (``models/layer.py`` slices them), and
runs everything here on that tile; the exchange over its graph line ships
``H/M * F``-wide rows, so a rank's bytes fall by ``M``.

Attention dropout: JAX folds the graph and model indices into the layer's
key (``jax.random.fold_in``), which torch cannot reproduce (``ROADMAP.md``
"RNG"). Here a tile's seed is ``shard_seed(seed, g, model_index=m,
num_shards=G)``, a pure int32 function of the layer's drawn seed and the
tile index ``g + m * G``: with ``M = 1`` the seed of graph shard ``g``, and
no two tiles share one. The kernels hash the tile's local head index, as
JAX's do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from relgat_projector_tpu_torch.data.csr import CSRGraph, build_csr_graph
from relgat_projector_tpu_torch.ops.segment import STABLE_SOFTMAX_EPS
from relgat_projector_tpu_torch.parallel.mesh import Grid, all_to_all


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class HaloGraph:
    """The host-side halo plan of all shards (JAX ``HaloGraph``, its arrays
    as numpy, stacked ``[G, ...]``).

    ``send_idx[o, d, :]`` are owner ``o``'s local row ids to ship to dest
    ``d`` (the diagonal is unused: own rows are read directly). Edge
    sources of the unsplit layout index ``[own rows (rows_per_shard) ++ halo
    buffer (G * halo_pair)]``; in overlap mode ``loc_src`` indexes own rows
    and ``rem_src`` the halo buffer. Padded edges carry ``mask`` 0 and point
    at the shard's last row."""

    send_idx: np.ndarray               # [G, G, Hp] int32
    src_halo: Optional[np.ndarray]     # [G, E_sh] int32 (None in overlap)
    dst_local: Optional[np.ndarray]    # [G, E_sh] int32
    etype: Optional[np.ndarray]        # [G, E_sh] int32
    mask: Optional[np.ndarray]         # [G, E_sh] float32
    loc_src: Optional[np.ndarray] = None    # [G, E_loc] int32 (own rows)
    loc_dst: Optional[np.ndarray] = None
    loc_etype: Optional[np.ndarray] = None
    loc_mask: Optional[np.ndarray] = None
    loc_eid: Optional[np.ndarray] = None
    rem_src: Optional[np.ndarray] = None    # [G, E_rem] int32 (halo buffer)
    rem_dst: Optional[np.ndarray] = None
    rem_etype: Optional[np.ndarray] = None
    rem_mask: Optional[np.ndarray] = None
    rem_eid: Optional[np.ndarray] = None
    overlap: bool = False
    num_shards: int = 1
    rows_per_shard: int = 0
    halo_pair: int = 0
    num_nodes: int = 0                 # num_shards * rows_per_shard
    num_real_edges: int = 0

    def exchange_bytes_per_device(self, feat_bytes: int) -> int:
        """Bytes each rank SENDS per layer per direction (``feat_bytes`` =
        H*F*itemsize)."""
        return (self.num_shards - 1) * self.halo_pair * feat_bytes

    def replication_bytes_per_device(self, feat_bytes: int) -> int:
        """What replicating every shard's rows would ship instead."""
        return (self.num_shards - 1) * self.rows_per_shard * feat_bytes


def halo_rows_per_shard(
    num_real_nodes: int,
    num_shards: int,
    *,
    blocked: bool = False,
    block_nodes: int = 128,
) -> int:
    """Destination rows owned per shard: the one definition of the
    contiguous node-range partition, which ``data/partition.py`` packs its
    clusters into. ``blocked`` rounds to the JAX package's TPU row blocks
    (``block_nodes``); the port's layouts take rows in multiples of 8."""
    row_mult = block_nodes if blocked else 8
    return _round_up(
        -(-(int(num_real_nodes) + 1) // int(num_shards)), row_mult
    )


def build_halo_graph(
    src: np.ndarray,
    dst: np.ndarray,
    etype: np.ndarray,
    num_real_nodes: int,
    num_shards: int,
    *,
    blocked: bool = False,
    block_nodes: int = 128,
    edge_pad_multiple: int = 8,
    overlap: bool = False,
) -> HaloGraph:
    """The halo plan of the real edges (JAX ``build_halo_graph`` without its
    TPU block layouts; the same integer arrays). The node space is padded
    to ``num_shards * rows_per_shard``."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    etype = np.asarray(etype, np.int64)
    g = int(num_shards)

    rows = halo_rows_per_shard(
        num_real_nodes, g, blocked=blocked, block_nodes=block_nodes
    )
    shard_of = np.minimum(dst // rows, g - 1)

    # Per-(dest, owner) boundary sets; own-shard sources are read directly.
    per_shard = []
    need = [[None] * g for _ in range(g)]
    for d in range(g):
        sel = shard_of == d
        s_d, d_d, e_d = src[sel], dst[sel], etype[sel]
        order = np.argsort(d_d, kind="stable")
        s_d, d_d, e_d = s_d[order], d_d[order] - d * rows, e_d[order]
        owners = s_d // rows
        for o in range(g):
            if o == d:
                need[d][o] = np.zeros((0,), np.int64)
            else:
                need[d][o] = np.unique(s_d[owners == o] - o * rows)
        per_shard.append((s_d, d_d, e_d, owners))

    hp_mult = block_nodes if blocked else 8
    hp = max(
        hp_mult,
        _round_up(
            max(
                (int(need[d][o].shape[0]) for d in range(g) for o in range(g)),
                default=1,
            ),
            hp_mult,
        ),
    )
    send_idx = np.zeros((g, g, hp), np.int32)
    for d in range(g):
        for o in range(g):
            n = need[d][o].shape[0]
            send_idx[o, d, :n] = need[d][o]

    # Per-shard edge arrays in halo space.
    e_sh = max(
        edge_pad_multiple,
        _round_up(
            max((p[0].shape[0] for p in per_shard), default=1) or 1,
            edge_pad_multiple,
        ),
    )
    src_h = np.zeros((g, e_sh), np.int32)
    dst_l = np.full((g, e_sh), rows - 1, np.int32)
    et_s = np.zeros((g, e_sh), np.int32)
    mask_s = np.zeros((g, e_sh), np.float32)
    halo_src_per_shard = []
    for d in range(g):
        s_d, d_d, e_d, owners = per_shard[d]
        n = s_d.shape[0]
        halo = np.zeros(n, np.int64)
        for o in range(g):
            m = owners == o
            if not m.any():
                continue
            if o == d:
                halo[m] = s_d[m] - d * rows
            else:
                halo[m] = rows + o * hp + np.searchsorted(
                    need[d][o], s_d[m] - o * rows
                )
        halo_src_per_shard.append(halo)
        src_h[d, :n] = halo
        dst_l[d, :n] = d_d
        et_s[d, :n] = e_d
        mask_s[d, :n] = 1.0

    # The local/remote split, with canonical edge ids = positions in the
    # shard's dst-sorted edge list (the ids the unsplit layout hashes).
    extra = {}
    if overlap:
        loc_lists, rem_lists = [], []
        for d in range(g):
            s_d, d_d, e_d, owners = per_shard[d]
            eid = np.arange(s_d.shape[0], dtype=np.int64)
            sel = owners == d
            loc_lists.append(
                (s_d[sel] - d * rows, d_d[sel], e_d[sel], eid[sel])
            )
            halo_ids = halo_src_per_shard[d]
            rsel = ~sel
            rem_lists.append(
                (halo_ids[rsel] - rows, d_d[rsel], e_d[rsel], eid[rsel])
            )

        def pad_stack(lists):
            e_max = max(
                edge_pad_multiple,
                _round_up(
                    max((x[0].shape[0] for x in lists), default=1) or 1,
                    edge_pad_multiple,
                ),
            )
            srcs = np.zeros((g, e_max), np.int32)
            dsts = np.full((g, e_max), rows - 1, np.int32)
            ets = np.zeros((g, e_max), np.int32)
            masks = np.zeros((g, e_max), np.float32)
            eids = np.zeros((g, e_max), np.int32)
            for d, (s_a, d_a, e_a, i_a) in enumerate(lists):
                n = s_a.shape[0]
                srcs[d, :n] = s_a
                dsts[d, :n] = d_a
                ets[d, :n] = e_a
                masks[d, :n] = 1.0
                eids[d, :n] = i_a
            return srcs, dsts, ets, masks, eids

        ls, ld, le, lm, li = pad_stack(loc_lists)
        rs, rd, re_, rm, ri = pad_stack(rem_lists)
        extra = dict(
            loc_src=ls, loc_dst=ld, loc_etype=le, loc_mask=lm, loc_eid=li,
            rem_src=rs, rem_dst=rd, rem_etype=re_, rem_mask=rm, rem_eid=ri,
            overlap=True,
        )

    return HaloGraph(
        **extra,
        send_idx=send_idx,
        src_halo=None if overlap else src_h,
        dst_local=None if overlap else dst_l,
        etype=None if overlap else et_s,
        mask=None if overlap else mask_s,
        num_shards=g,
        rows_per_shard=rows,
        halo_pair=hp,
        num_nodes=g * rows,
        num_real_edges=int(src.shape[0]),
    )


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeSubset:
    """One layout of a shard's real edges, dst-sorted, on its device:
    ``src`` indexes a source space of ``num_src`` rows, ``dst`` the shard's
    rows; ``eid`` are the canonical per-shard ids; ``csr`` is the kernels'
    layout (None on the plain route)."""

    src: torch.Tensor
    dst: torch.Tensor
    etype: torch.Tensor
    eid: torch.Tensor
    num_src: int
    csr: Optional[CSRGraph]

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


@dataclasses.dataclass(frozen=True, eq=False)
class HaloShard:
    """What the rank at graph index ``index`` holds of a ``HaloGraph``: its
    send lists ``send_idx [G * Hp]`` (row ids into its own rows) and its
    edges, as the ``loc``/``rem`` subsets (overlap) or one ``whole`` layout
    over ``[own rows ++ halo buffer]``."""

    grid: Grid
    index: int
    num_shards: int
    rows: int
    halo_pair: int
    send_idx: torch.Tensor
    overlap: bool
    loc: Optional[EdgeSubset] = None
    rem: Optional[EdgeSubset] = None
    whole: Optional[EdgeSubset] = None

    @property
    def row_range(self):
        lo = self.index * self.rows
        return lo, lo + self.rows


def _subset(src, dst, et, eid, mask, num_src, rows, num_rel, device,
            csr) -> EdgeSubset:
    real = mask > 0
    src, dst, et, eid = (np.asarray(a)[real].astype(np.int64)
                         for a in (src, dst, et, eid))
    layout = (build_csr_graph(src, dst, et, rows, num_rel, device,
                              num_src=num_src, eid=eid) if csr else None)

    def t(a):
        return torch.from_numpy(a).to(device)

    return EdgeSubset(src=t(src), dst=t(dst), etype=t(et), eid=t(eid),
                      num_src=int(num_src), csr=layout)


def shard_edges(hg: HaloGraph, g: int, num_rel: int, device: torch.device,
                *, csr: bool = False):
    """Shard ``g``'s edge layouts on ``device``: ``{"loc", "rem"}`` in
    overlap mode, else ``{"whole"}`` (each an ``EdgeSubset``)."""
    rows, hp = hg.rows_per_shard, hg.halo_pair
    kw = dict(rows=rows, num_rel=num_rel, device=device, csr=csr)
    parts = {}
    if hg.overlap:
        parts["loc"] = _subset(hg.loc_src[g], hg.loc_dst[g],
                               hg.loc_etype[g], hg.loc_eid[g],
                               hg.loc_mask[g], rows, **kw)
        parts["rem"] = _subset(hg.rem_src[g], hg.rem_dst[g],
                               hg.rem_etype[g], hg.rem_eid[g],
                               hg.rem_mask[g], hg.num_shards * hp, **kw)
    else:
        n = hg.src_halo.shape[1]
        parts["whole"] = _subset(hg.src_halo[g], hg.dst_local[g],
                                 hg.etype[g], np.arange(n), hg.mask[g],
                                 rows + hg.num_shards * hp, **kw)
    return parts


def place_halo_graph(
    hg: HaloGraph,
    grid: Grid,
    num_rel: int,
    device: torch.device,
    *,
    csr: bool = False,
) -> HaloShard:
    """The rank's shard of ``hg`` (graph index ``grid.graph_index``) on
    ``device``; ``csr`` builds the kernels' layouts of its edges."""
    if grid.graph != hg.num_shards:
        raise ValueError(
            f"a halo plan of {hg.num_shards} shards on a grid with "
            f"graph axis {grid.graph}"
        )
    g, rows, hp = grid.graph_index, hg.rows_per_shard, hg.halo_pair
    parts = shard_edges(hg, g, num_rel, device, csr=csr)
    send = torch.from_numpy(hg.send_idx[g].reshape(-1).astype(np.int64))
    return HaloShard(
        grid=grid, index=g, num_shards=hg.num_shards, rows=rows,
        halo_pair=hp, send_idx=send.to(device), overlap=hg.overlap, **parts,
    )


def shard_seed(seed: int, shard: int, *, model_index: int = 0,
               num_shards: int = 1) -> int:
    """The attention-dropout seed of the tile at graph shard ``shard`` and
    model index ``model_index`` (of a grid with ``num_shards`` graph
    shards) from a layer's int32 ``seed``: the fmix32 finalizer of ``seed
    + (t + 1) * 0x9E3779B9`` (mod 2**32) with ``t = shard + model_index *
    num_shards``, as a signed int32. The finalizer and the odd multiplier
    are bijections, so no two tiles of a layer share a seed, and model
    index 0 gives graph shard ``shard``'s seed."""
    tile = int(shard) + int(model_index) * int(num_shards)
    x = (int(seed) + (tile + 1) * 0x9E3779B9) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x - (1 << 32) if x >= 1 << 31 else x


class _Exchange(torch.autograd.Function):
    """``recv[o] = send_o[me]`` over the graph line; its backward is the
    same exchange of the cotangents, which returns each one to its
    sender."""

    @staticmethod
    def forward(ctx, send, grid: Grid):
        ctx.grid = grid
        return all_to_all(send, grid.graph_group, grid.backend)

    @staticmethod
    def backward(ctx, g):
        grid = ctx.grid
        return all_to_all(g, grid.graph_group, grid.backend), None


def halo_exchange(h_rows: torch.Tensor, shard: HaloShard) -> torch.Tensor:
    """The halo buffer ``[G * Hp, H*F]`` of this shard from its own rows
    ``[rows, H*F]``: block ``o`` holds the rows owner ``o`` sent (block
    ``index`` is unused)."""
    g, hp = shard.num_shards, shard.halo_pair
    send = h_rows.index_select(0, shard.send_idx).view(g, hp, -1)
    return _Exchange.apply(send, shard.grid).view(g * hp, -1)


def halo_propagate(
    h: torch.Tensor,               # [rows, H, F] this shard's rows
    attn_bank: torch.Tensor,       # [H, R, F]
    rel_bias: Optional[torch.Tensor],
    shard: HaloShard,
    *,
    use_pallas: bool = False,
    negative_slope: float = 0.2,
    eps: float = STABLE_SOFTMAX_EPS,
    attn_dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    kernel_precision: str = "highest",
) -> torch.Tensor:
    """The shard's aggregate ``[rows, H, F]`` (JAX ``halo_propagate``): the
    exchange, then the overlapped (local and remote subsets, merged) or the
    unsplit propagate over the shard's edges; ``use_pallas`` runs the
    kernels, else the plain route. Under head tensor parallelism ``h``,
    ``attn_bank`` and the result hold the rank's heads. ``dropout_seed`` is
    the layer's seed; the tile hashes with its ``shard_seed``."""
    if not isinstance(shard, HaloShard):
        raise ValueError(
            "the graph holds the halo plan of every shard: place this "
            "rank's shard with parallel.place_halo_graph first"
        )
    rows, heads, f = h.shape
    if rows != shard.rows:
        raise ValueError(f"h has {rows} rows, the shard {shard.rows}")
    seed = None
    if attn_dropout_rate > 0.0 and dropout_seed is not None:
        seed = shard_seed(dropout_seed, shard.index,
                          model_index=shard.grid.model_index,
                          num_shards=shard.num_shards)
    rate = attn_dropout_rate if seed is not None else 0.0
    halo = halo_exchange(h.reshape(rows, heads * f), shard)
    halo = halo.view(-1, heads, f)
    kw = dict(negative_slope=negative_slope, attn_dropout_rate=rate,
              dropout_seed=seed)
    if shard.overlap:
        if use_pallas:
            from relgat_projector_tpu_torch.ops.propagate import (
                relgat_propagate_kernels_overlapped,
            )

            return relgat_propagate_kernels_overlapped(
                h, halo, attn_bank, rel_bias, shard.loc.csr, shard.rem.csr,
                eps=eps, kernel_precision=kernel_precision, **kw,
            )
        from relgat_projector_tpu_torch.ops.relgat_ops import (
            merge_propagate_partials,
            relgat_propagate_partial,
        )

        parts = [
            relgat_propagate_partial(
                space, attn_bank, rel_bias, sub.src, sub.dst, sub.etype,
                num_out=rows, dropout_edge_ids=sub.eid, **kw,
            )
            for space, sub in ((h, shard.loc), (halo, shard.rem))
        ]
        return merge_propagate_partials(parts, eps=eps)
    h_halo = torch.cat([h, halo])
    whole = shard.whole
    if use_pallas:
        from relgat_projector_tpu_torch.ops.propagate import (
            relgat_propagate_kernels,
        )

        return relgat_propagate_kernels(
            h_halo, attn_bank, rel_bias, whole.csr, eps=eps,
            kernel_precision=kernel_precision, **kw,
        )
    from relgat_projector_tpu_torch.ops.relgat_ops import _plain_propagate

    return _plain_propagate(
        h_halo, attn_bank, rel_bias, whole.src, whole.dst, whole.etype,
        num_nodes=rows, eps=eps, **kw,
    )
