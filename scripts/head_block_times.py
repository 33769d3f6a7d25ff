"""Time the projection head's fused GELU -> LayerNorm kernels on the card.

    python3 scripts/head_block_times.py [--rows 100000] [--widths 2048,1152]
        [--reps 20] [--out DIR]

At each width, on ``--rows`` rows of random fp32 y with fp32 scale and
bias and a bf16 dz (the ``small-bf16`` head's shapes by default: 100,000
nodes, hidden width 2048), CUDA events time, as the mean of ``--reps``
calls after a warm-up: ``gelu_layer_norm_fwd`` (z in bf16),
``gelu_layer_norm_bwd``, and, each forward, backward alone (on a kept
graph) and forward and backward, the plain composition
(``gelu_layer_norm_plain``, what the head ran before the kernels) and the
library's own fused route, ``F.layer_norm(F.gelu(y), (d,), scale, bias,
1e-5)`` (PyTorch's LayerNorm kernels, the scale and bias gradients summed
inside its backward); both of those give an fp32 z. Each kernel's bound is
its bytes (inputs read once, outputs written once) at 3.35 TB/s. Prints one JSON line with the
card's name and power limit (``--out`` also writes it to
``DIR/head_block_times.json``). Needs a CUDA card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from relgat_projector_tpu_torch.ops.cuda import (  # noqa: E402
    gelu_layernorm as gln,
)

HBM_BYTES_PER_S = 3.35e12


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def width_row(n, d, reps):
    gen = torch.Generator(device="cuda").manual_seed(d)
    y = torch.randn((n, d), generator=gen, device="cuda")
    scale = 1 + 0.2 * torch.randn((d,), generator=gen, device="cuda")
    bias = 0.1 * torch.randn((d,), generator=gen, device="cuda")
    dz = torch.randn((n, d), generator=gen, device="cuda").bfloat16()
    z, mean, rstd = gln.gelu_layer_norm_fwd(y, scale, bias, torch.bfloat16)
    fwd_ms = _ms(lambda: gln.gelu_layer_norm_fwd(y, scale, bias,
                                                 torch.bfloat16), reps)
    bwd_ms = _ms(lambda: gln.gelu_layer_norm_bwd(dz, y, scale, mean, rstd),
                 reps)
    yg = y.detach().requires_grad_()
    sg = scale.detach().requires_grad_()
    bg = bias.detach().requires_grad_()
    leaves = (yg, sg, bg)
    dzf = dz.float()  # outside the timings: both routes take fp32 dz
    routes = {
        "plain": lambda: gln.gelu_layer_norm_plain(yg, sg, bg),
        "library": lambda: F.layer_norm(F.gelu(yg, approximate="none"),
                                        (d,), sg, bg, 1e-5),
    }
    times = {}
    for name, route in routes.items():
        with torch.no_grad():
            times[f"{name}_fwd_ms"] = _ms(route, reps)
        out = route()
        times[f"{name}_bwd_ms"] = _ms(lambda: torch.autograd.grad(
            out, leaves, dzf, retain_graph=True), reps)
        del out
        times[f"{name}_fwd_bwd_ms"] = _ms(lambda: torch.autograd.grad(
            route(), leaves, dzf), reps)
    # bytes: y fp32 in, z bf16 out, mean and rstd out; dz bf16 and y in,
    # dy fp32 out, mean and rstd in, dscale and dbias out
    fwd_bytes = 4 * n * d + 2 * n * d + 8 * n + 8 * d
    bwd_bytes = 2 * n * d + 4 * n * d + 4 * n * d + 8 * n + 12 * d
    fwd_bound = 1e3 * fwd_bytes / HBM_BYTES_PER_S
    bwd_bound = 1e3 * bwd_bytes / HBM_BYTES_PER_S
    return {
        "rows": n, "width": d,
        "fwd_ms": fwd_ms, "fwd_bound_ms": fwd_bound,
        "fwd_roofline": fwd_bound / fwd_ms,
        "bwd_ms": bwd_ms, "bwd_bound_ms": bwd_bound,
        "bwd_roofline": bwd_bound / bwd_ms,
        "fwd_bwd_ms": fwd_ms + bwd_ms, **times,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=100_000)
    p.add_argument("--widths", default="2048,1152")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("head_block_times: no CUDA device", file=sys.stderr)
        return 2
    line = {"card": _card(),
            "widths": [width_row(args.rows, int(d), args.reps)
                       for d in args.widths.split(",")]}
    text = json.dumps(line)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "head_block_times.json").write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
