"""Bisect the MSDA sampling cost on the card: the empty / dot-only /
no-construct / full variants of one level's separable sampling (K6,
`csrc/msda_ablate.cu`) at one level's eval shapes.

    python -m s2d_tpu_torch.tools.bench_pallas_ablate [--h 12] [--w 20] \
        [--g 8] [--p-tile 512] [--seed 0]

The counterpart of `tools/bench_pallas_ablate.py`, the same bisection of
the same function: the same flags, shapes and gqp padding (n=64 queries
groups of g, d=32 channels, qp=19,360 points, k=128 rows; gqp = g*qp padded
up to a multiple of p_tile), inputs drawn from a torch.Generator seeded by
--seed. Each variant is timed on the card with CUDA events over ITERS
calls after a warm-up call (1 + ITERS launches of its kernel), then the
tool prints each variant's bound (its bytes at the H100's HBM rate, or its
operations at its f32 rate) and the largest difference of the warm-up
call's output from the plain version (`ops/msda_ablate.msda_ablate_plain`).
`run` takes any namespace with the fields `parse_args` gives; on a CPU
device the kernels' plain versions run and the times are host times.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from ..ops.msda_ablate import VARIANTS, msda_ablate_plain
from ..ops.msda_ablate_cuda import msda_ablate

# published peaks of one H100 SXM at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the JAX tool's fixed sizes: queries, channels, points per query, rows of vt
N, D, QP, K = 64, 32, 19360, 128
ITERS = 10


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h", type=int, default=12)
    ap.add_argument("--w", type=int, default=20)
    ap.add_argument("--g", type=int, default=8)
    ap.add_argument("--p-tile", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.set_defaults(n=N, d=D, qp=QP, k=K, iters=ITERS, device="cuda")
    return ap.parse_args(argv)


def make_inputs(args, device) -> dict:
    """vt (ng, W*d, k) bf16 and the six (ng, 1, gqp) point arrays, from a
    generator seeded by args.seed, as the JAX tool draws them."""
    ng = args.n // args.g
    gqp = -(-args.g * args.qp // args.p_tile) * args.p_tile
    gen = torch.Generator(device=device).manual_seed(args.seed)
    pts = (ng, 1, gqp)
    return dict(
        vt=torch.randn(ng, args.w * args.d, args.k, generator=gen, device=device).to(torch.bfloat16),
        ya=torch.randint(0, args.h * args.g, pts, generator=gen, device=device, dtype=torch.int32),
        x0=torch.randint(0, args.w, pts, generator=gen, device=device, dtype=torch.int32),
        wy0=torch.rand(pts, generator=gen, device=device),
        wy1=torch.rand(pts, generator=gen, device=device),
        wx0=torch.rand(pts, generator=gen, device=device),
        wx1=torch.rand(pts, generator=gen, device=device),
    )


def call(fn, variant, inputs, args):
    i = inputs
    return fn(variant, i["vt"], i["ya"], i["wy0"], i["wy1"], i["x0"], i["wx0"], i["wx1"],
              args.w, args.d)


def work(variant: str, inputs: dict, d: int) -> tuple[int, int]:
    """(bytes, operations) of one call: each input the variant reads, read
    once, and the output written once; per output value, the products and
    sums of its bilinear terms."""
    vt = inputs["vt"]
    ng, _, k = vt.shape
    gqp = inputs["ya"].shape[-1]
    out_bytes = ng * d * gqp * 4
    point = ng * gqp * 4
    if variant == "empty":
        return out_bytes, 0
    if variant == "noconstruct":
        return out_bytes + ng * d * 2, ng * d  # vt[:, :d, 0], one product each
    if variant == "dotonly":
        # vt[:, :d], ya, wy0, wy1; 2 products + 1 sum per output
        return out_bytes + ng * d * k * 2 + 3 * point, 3 * ng * d * gqp
    # all of vt, the six point arrays; 2 x (2 products + 1 sum), 2 products + 1 sum
    return out_bytes + vt.numel() * 2 + 6 * point, 9 * ng * d * gqp


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_ms(fn, device, iters: int) -> float:
    """Mean time of one call: CUDA events on a card, the host clock on the
    CPU."""
    if device.type != "cuda":
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - start) / iters * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def run(args) -> dict:
    """{variant: {"ms", "bound_ms", "bound_by", "max_abs_err"}}, printed."""
    device = torch.device(args.device)
    inputs = make_inputs(args, device)
    ng, wd, k = inputs["vt"].shape
    gqp = inputs["ya"].shape[-1]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"vt {(ng, wd, k)} bf16, points {(ng, 1, gqp)}, out {(ng, args.d, gqp)} f32 on {name}",
          flush=True)
    report, outputs = {}, {}
    for variant in VARIANTS:
        outputs[variant] = call(msda_ablate, variant, inputs, args)  # the warm-up
        ms = time_ms(lambda: call(msda_ablate, variant, inputs, args), device, args.iters)
        report[variant] = {"ms": ms}
        print(f"{variant}: {ms:.4f} ms", flush=True)
    for variant in VARIANTS:
        got = outputs.pop(variant)
        err = (got - call(msda_ablate_plain, variant, inputs, args)).abs().max().item()
        ms, by = bound_ms(*work(variant, inputs, args.d))
        report[variant].update(bound_ms=ms, bound_by=by, max_abs_err=err)
        print(f"{variant}: bound {ms:.4f} ms ({by}), max |kernel - plain| {err:.3e}", flush=True)
    return report


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
