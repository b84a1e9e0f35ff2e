"""Attribute the fused AMP stage's interior time on the card.

    python -m audiolcm_torch.tools.profile_stage_interior            # both serving shapes
    python -m audiolcm_torch.tools.profile_stage_interior 24 159744  # one shape
    python -m audiolcm_torch.tools.profile_stage_interior --iters 5 --only full,act2,act6
    python -m audiolcm_torch.tools.profile_stage_interior --device cpu  # tiny CPU smoke

The port of `tools/profile_stage_interior.py`, with its rows. The fused
stage (K1, `nn/amp_stage.py`) is one kernel with no profiler inside, so its
interior is attributed by differences between launches of variants at
batch 8, bf16, fast snake:

  1. resblock subsets: kernel sizes (3,), (3, 7), (3, 7, 11); the deltas
     are each resblock's marginal cost;
  2. dilation subsets: (1,) vs (1, 3, 5), the cost of an extra sub-unit
     (act -> conv(d) -> act -> conv(1));
  3. exact-cos: the stage with cosf in place of the polynomial cos;
  4. accum-f32: the JAX f32-accumulation knob. The port's K1 sums in f32
     and keeps the residual in f32 in both accum modes, so this row times
     the same launch as "full"; it stays so the table lines up with the JAX
     tool's;
  5. act-only: the activation chain K4 (`nn/act_chain.py`) at n_rep 2 and
     6; the slope (n6 - n2) / 4 is one alias-free SnakeBeta unit with the
     load and store cancelled. The stage runs 2 * 3 * 3 = 18 units, so
     act_total = 18 * unit and conv + overhead = full - act_total. K4 runs
     its own design (register runs, halos by shuffle), not K1's activation
     code, so act_total is what K1's activations would cost in K4's design
     and conv + overhead what K1 would keep.

Each kernel runs at its own tile: K1's route's tile (bf16: the
tensor-core kernel's `pick_tile_mma`) for the variant's own stage (a
subset has a smaller halo and may take a wider tile), K4's
`act_chain.pick_tile`. Times are CUDA events around `--iters` launches
after one warm-up. Any failure raises.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from audiolcm_torch.nn.act_chain import act_chain, act_chain_tiles_emulated
from audiolcm_torch.nn.act_chain import pick_tile as act_tile
from audiolcm_torch.nn.amp_stage import fused_amp_stage, pack_stage, pick_route, route_tile

KS, DS = (3, 7, 11), (1, 3, 5)
N_ACTS = 2 * len(KS) * len(DS)  # 2 acts per sub-unit x 3 dilations x 3 resblocks
SERVING_SHAPES = ((48, 79872), (24, 159744))  # the two fused stages of a 10 s clip
ALPHA, BETA = 0.3, 1.0  # the act rows' snake parameters, as in the JAX tool
# (key, label) in the JAX tool's order
ROWS = (("full", "full k(3,7,11) d(1,3,5)"), ("k37", "k(3,7)"), ("k3", "k(3)"),
        ("d1", "dil(1)"), ("slow", "exact-cos"), ("accf32", "accum-f32"),
        ("act2", "act-only n_rep=2"), ("act6", "act-only n_rep=6"))
# stage rows: key -> (kernel sizes, dilations, fast, accum) of the K1 launch
STAGE_VARIANTS = {"full": (KS, DS, True, "bf16"), "k37": (KS[:2], DS, True, "bf16"),
                  "k3": (KS[:1], DS, True, "bf16"), "d1": (KS, DS[:1], True, "bf16"),
                  "slow": (KS, DS, False, "bf16"), "accf32": (KS, DS, True, "f32")}


def make_stage_params(c: int, device, dtype=torch.bfloat16, seed: int = 0) -> List[dict]:
    """Stage parameters of k(3,7,11) x d(1,3,5) from a numpy seed with the
    JAX tool's scale: every raw parameter 0.1 * N(0, 1), snakes log-scale."""
    rng = np.random.default_rng(seed)
    draw = lambda *shape: torch.from_numpy(0.1 * rng.standard_normal(shape)).float()
    out = []
    for k in KS:
        subs = []
        for _ in DS:
            s = {n: draw(c).exp() for n in ("a1", "b1", "a2", "b2")}
            s.update(w1=draw(c, c, k), c1b=draw(c), w2=draw(c, c, k), c2b=draw(c))
            subs.append({n: v.to(device=device, dtype=dtype) for n, v in s.items()})
        out.append({"sub": subs})
    return out


def subset(sp: List[dict], ks: Sequence[int], ds: Sequence[int]) -> List[dict]:
    """The first len(ks) resblocks, each cut to its first len(ds) sub-units."""
    return [{"sub": blk["sub"][:len(ds)]} for blk in sp[:len(ks)]]


def event_ms(fn: Callable, iters: int) -> float:
    """CUDA-event ms per call of fn over `iters` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def variants(x: torch.Tensor, sp: List[dict]) -> Dict[str, tuple]:
    """key -> (tile, zero-argument call) for every row."""
    c = x.shape[-1]
    alpha = torch.full((c,), ALPHA, device=x.device).bfloat16()  # the JAX tool's bf16 alpha
    beta = torch.full((c,), BETA, device=x.device)

    def stage(ks, ds, fast, accum):
        p = pack_stage(subset(sp, ks, ds), ks, ds, x.dtype, x.device)
        return (route_tile(pick_route(x), c, ks, ds, x.shape[0], x.shape[1]),
                lambda: fused_amp_stage(x, p, ks, ds, fast=fast, accum=accum))

    def act(n):
        return act_tile(n), lambda: act_chain(x, alpha, beta, n, fast=True)

    calls = {key: stage(*v) for key, v in STAGE_VARIANTS.items()}
    return {**calls, "act2": act(2), "act6": act(6)}


def print_row(row: dict) -> None:
    """The JAX tool's text lines."""
    kind = row["row"]
    if kind == "shape":
        print(f"=== C={row['C']} T={row['T']} tile={row['tile']} b={row['batch']} "
              f"iters={row['iters']} ===", flush=True)
    elif kind == "marginal":
        print(f"  marginal resblock: k7 {row['k7_ms']:+.2f} ms, k11 {row['k11_ms']:+.2f} ms"
              f" | per extra dilation sub-unit {row['per_extra_dilation_sub_unit_ms']:+.2f} ms"
              f" | fast_cos saves {row['fast_cos_saves_ms']:+.2f} ms"
              f" | f32-FIR-accum adds {row['f32_accum_adds_ms']:+.2f} ms", flush=True)
    elif kind == "act_split":
        print(f"  act-only: n_rep2 {row['act2_ms']:.2f} ms, n_rep6 {row['act6_ms']:.2f} ms -> "
              f"unit {row['unit_ms']:.3f} ms/act; stage runs {row['n_acts']} acts = "
              f"{row['act_total_ms']:.1f} ms act vs {row['conv_plus_overhead_ms']:.1f} ms "
              f"conv+overhead (of {row['full_ms']:.1f} full)", flush=True)
    else:
        print(f"  {row['label']}: {row['ms']:7.2f} ms", flush=True)


def profile_shape(c: int, t: int, device, iters: int = 5, only: Sequence[str] = (),
                  batch: int = 8, report: Callable[[dict], None] = print_row,
                  timer: Optional[Callable[[Callable, int], float]] = None) -> dict:
    """Time every wanted row at (batch, t, c) bf16 on the card; report each
    row as it is measured, so a late failure keeps the earlier rows, and
    return the ms of every row plus the derived lines. Rows not wanted are
    NaN. timer(fn, iters) -> ms defaults to CUDA events (`event_ms`)."""
    timer = timer or event_ms
    device = torch.device(device)
    x = torch.randn(batch, t, c, generator=torch.Generator(device).manual_seed(1),
                    device=device, dtype=torch.bfloat16)
    calls = variants(x, make_stage_params(c, device))
    report({"row": "shape", "C": c, "T": t, "tile": calls["full"][0], "batch": batch,
            "iters": iters})
    ms: Dict[str, float] = {}

    def timed(key: str, label: str) -> None:
        if only and key not in only:
            ms[key] = math.nan
            return
        tile, fn = calls[key]
        ms[key] = timer(fn, iters)
        report({"row": key, "label": label, "ms": ms[key], "tile": tile})

    with torch.inference_mode():
        for key, label in ROWS[:6]:
            timed(key, label)
        marginal = {"row": "marginal", "k7_ms": ms["k37"] - ms["k3"],
                    "k11_ms": ms["full"] - ms["k37"],
                    "per_extra_dilation_sub_unit_ms": (ms["full"] - ms["d1"]) / 2,
                    "fast_cos_saves_ms": ms["slow"] - ms["full"],
                    "f32_accum_adds_ms": ms["accf32"] - ms["full"]}
        report(marginal)
        for key, label in ROWS[6:]:
            timed(key, label)
    unit = (ms["act6"] - ms["act2"]) / 4
    split = {"row": "act_split", "act2_ms": ms["act2"], "act6_ms": ms["act6"], "unit_ms": unit,
             "n_acts": N_ACTS, "act_total_ms": unit * N_ACTS,
             "conv_plus_overhead_ms": ms["full"] - unit * N_ACTS, "full_ms": ms["full"]}
    report(split)
    return {"C": c, "T": t, "batch": batch, "iters": iters, "ms": ms, "marginal": marginal,
            "act_split": split}


def cpu_smoke() -> float:
    """The JAX tool's interpret smoke at its tiny shape, on the plain
    versions: one stage variant, and one act variant checked against the
    kernel's tiling in f32 (the 0.2 bar of the JAX smoke: an alignment bug
    gives O(1) errors, bf16 rounding ~0.05)."""
    c, t, tile, b = 24, 512, 256, 1
    x = torch.randn(b, t, c, generator=torch.Generator().manual_seed(1)).bfloat16()
    sp = make_stage_params(c, "cpu")
    y = fused_amp_stage(x, pack_stage(subset(sp, (3,), (1,)), (3,), (1,), x.dtype, x.device),
                        (3,), (1,), fast=True)
    print("stage smoke ok:", tuple(y.shape))
    alpha, beta = torch.full((c,), ALPHA).bfloat16(), torch.full((c,), BETA)
    y = act_chain(x, alpha, beta, 2)
    ref = act_chain_tiles_emulated(x.float(), alpha, beta, 2, tile=tile)
    d = (y.float() - ref).abs().max().item()
    print(f"act smoke ok: {tuple(y.shape)} maxdiff vs reference {d:.3e}")
    if not d < 0.2:
        raise AssertionError(f"act chain smoke: max diff {d} against the reference")
    return d


def main(argv: Optional[List[str]] = None) -> None:
    from audiolcm_torch.pipeline import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("shape", nargs="*", type=int, help="C T (default: both serving shapes)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:0); 'cpu' runs the tiny smoke")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--only", default="", help="comma list of rows, e.g. full,act2,act6")
    args = p.parse_args(argv)
    if args.shape and len(args.shape) != 2:
        p.error("give both C and T, or neither")
    device = resolve_device(args.device)
    if device.type == "cpu":
        cpu_smoke()
        return
    only = tuple(filter(None, args.only.split(",")))
    for c, t in [tuple(args.shape)] if args.shape else SERVING_SHAPES:
        profile_shape(c, t, device, args.iters, only)


if __name__ == "__main__":
    main(sys.argv[1:])
