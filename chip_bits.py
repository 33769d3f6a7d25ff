"""Hold two checkouts' propagate kernels to each other bit for bit, on a card.

The kernels of the checkout this file lies in (fp32 and bf16; forward, src
pass and relation reduction; attention dropout 0 and 0.3) run on seeded
inputs in each of ``CASES`` and a SHA-256 digest of each output's bytes is
saved, with the launches each case counted by kernel design
(``design_counts``, and ``ring_loop_counts`` where the checkout has it);
``compare`` holds two such files to each other. Python puts a script's own
directory first on its path, so a copy of this file in another checkout's
root runs that checkout's kernels:

    python3 chip_bits.py run A.pt
    cp chip_bits.py OTHER/ && python3 OTHER/chip_bits.py run B.pt
    python3 chip_bits.py compare A.pt B.pt   # exit 0: the same bits
"""
import hashlib
import sys

import numpy as np
import torch

# (graph, heads, features). The sparse graph is chip_smoke.py's TRAIN
# graph (100k nodes, 1M edges, a hub row the forward splits, 40 relations):
# at 16 x 128 the bf16 pair kernels run, at 12 x 300 the rings with their
# per-edge loop. The dense graph (20k nodes, 2M edges, 100 relations, a
# row split in each pass) at the large preset's 12 x 256 runs the bf16
# lanes forward at 256, the bf16 ring src pass's factored loop
# (ops/cuda/fused.py ring_src_loop) and the tensor-core relation reduction.
CASES = (("sparse", 16, 128), ("sparse", 12, 300), ("dense", 12, 256))
GRAPHS = {"sparse": (100_000, 1_000_000, 40), "dense": (20_000, 2_000_000, 100)}


def digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def make_graph(name):
    from relgat_projector_tpu_torch.data.graph import build_graph

    rng = np.random.default_rng(0)
    n, e, r = GRAPHS[name]
    src, dst, et = (rng.integers(0, n, e), rng.integers(0, n, e),
                    rng.integers(0, r, e))
    if name == "sparse":
        dst[:60_000] = 5  # a hub the forward splits
    else:
        dst[:5_000], src[5_000:10_000] = 5, 7  # a row split in each pass
    return build_graph(src, dst, et, n, num_rel=r, csr=True, device="cuda"), r


def run(out):
    from relgat_projector_tpu_torch.ops import cuda as kern

    res, launched = {}, {}
    for name in GRAPHS:
        g, r = make_graph(name)
        for graph, heads, feat in CASES:
            if graph != name:
                continue
            kern.reset_design_counts()
            prefix = "" if name == "sparse" else f"{name}_"
            res.update({prefix + k: v for k, v in
                        shape_digests(kern, g, r, heads, feat).items()})
            launched[f"{prefix}{heads}x{feat}"] = {
                **kern.design_counts(),
                **(kern.ring_loop_counts()
                   if hasattr(kern, "ring_loop_counts") else {})}
        del g
        torch.cuda.empty_cache()
    res["launched"] = launched
    torch.save(res, out)
    print("saved", out, sorted(res))
    print("launched:", launched)


def shape_digests(kern, g, r, heads, feat):
    gen = torch.Generator(device="cuda").manual_seed(1)
    h = torch.randn((g.num_nodes, heads * feat), generator=gen, device="cuda")
    cot = torch.randn(h.shape, generator=gen, device="cuda")
    attn = torch.randn((heads, r, feat), generator=gen, device="cuda") * 0.3
    bias = torch.randn((r,), generator=gen, device="cuda") * 0.1
    res = {}
    for bf16 in (False, True):
        fwd, bsrc, brel = ((kern.relgat_fwd_bf16, kern.relgat_bwd_src_bf16,
                            kern.relgat_bwd_rel_bf16) if bf16 else
                           (kern.relgat_fwd, kern.relgat_bwd_src,
                            kern.relgat_bwd_rel))
        rows = h.to(torch.bfloat16) if bf16 else h
        grows = cot.to(torch.bfloat16) if bf16 else cot
        for seed, rate in ((None, 0.0), (77, 0.3)):
            kw = dict(seed=seed, rate=rate, negative_slope=0.2, eps=1e-16)
            o, m, l, b = fwd(rows, attn, bias, g.csr, **kw)
            s_dot = ((o - b[:, None]) * cot).view(-1, heads, feat).sum(-1)
            dh, w, bb = bsrc(rows, grows, attn, m, l, s_dot, cot.sum(1),
                             g.csr, **kw)
            da, db = brel(rows, w, bb)
            key = f"{heads}x{feat}_{'bf16' if bf16 else 'fp32'}_{rate}"
            res[key] = [digest(x) for x in (o, m, l, b, dh, w, bb, da, db)]
    return res


OUTPUTS = ("out", "m", "l", "bias", "dh", "w", "b", "dattn", "dbias")


def compare(a, b):
    x, y = torch.load(a), torch.load(b)
    same = {k: x[k] == y.get(k) for k in sorted(x)}
    print("same bits:", same)
    for k in sorted(x):
        if not same[k] and k == "launched":
            print("launched differ:", x[k], y.get(k))
        elif not same[k]:
            print("differ:", k, [o for o, p, q in
                                 zip(OUTPUTS, x[k], y.get(k, [None] * 9))
                                 if p != q])
    return 0 if all(same.values()) and sorted(x) == sorted(y) else 1


if __name__ == "__main__":
    if sys.argv[1] == "run":
        run(sys.argv[2])
    else:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
