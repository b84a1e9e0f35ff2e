#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (audiolcm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # on the machine with the card
    python3 chip_smoke.py --cpu-rehearsal  # tiny widths on the CPU, plain versions

Phases, one JSON line each; any failure raises and exits non-zero:
  1. card     — device name and count, nvidia-smi name and power limit
  2. build    — every csrc/*.cu compiled with nvcc for sm_90a, one nvcc per
                source, all started together (ptxas stats, K4's registers,
                spills and shared memory, K1's registers and spills; the
                tensor-core instructions in each kernel's SASS: HMMA > 0 in
                every bf16 kernel of K3, HGMMA > 0 in every bf16 kernel of
                K1 and K6, none of either in K1's f32 CUDA-core kernel)
  3. check    — each kernel against its plain PyTorch version on the card at
                the main paths' shapes (f32 with TF32 off, and bf16): the AMP
                stage K1 (at batch 2 and at each shape the time phase
                times, each at its own tile, also at a ragged T at batch 8
                and 1), K1 at each stage variant of the profiler, its
                per-item forms K2a/K2b (f32 on K1's CUDA-core kernel, bf16 on
                its tensor-core kernel, counted in `amp_stage.mma`; bf16 held
                over the whole output, its edges and its last tile), flash
                attention K3 (f32 on its CUDA-core kernel, bf16 on its
                tensor-core kernel through the 16-byte or the element-wise
                loads; also at the Flag teacher's self-attention and its
                caption branch, 312 queries over 154 keys, each call of the
                latter counted in `flash_attention.cross`), the activation
                chain K4 (n_rep 1, 2, 6, MAX_NREP)
  4. time     — each kernel, its plain version, the bound and (K3, also
                at both Flag teacher shapes) the library call, bf16 (K1 at
                batch 8 and at batch 1 of a 20 s clip, also its device time
                in the profiler, its activations' CUDA-core floor and, for
                information, its 18 convs alone through cuDNN); the
                alias-free activation at every stage width of a batch-8 10 s
                and a batch-1 20 s generate (`act_forms`): the depthwise-conv
                and polyphase forms, and K5 beside its bounds, with its f32
                and bf16 errors against its plain version; K6 at the same
                stages (`wide_conv_forms`): a stage's 18 resblock convs with
                their sums against cuDNN's, its bound, its bf16 error
                against cuDNN's bf16 route; K7 (`moe_kernel`): the routed
                experts at Moonlight-16B-A3B's widths (64 experts of 2048
                -> 1408, top 6), 128 and 1024 tokens, routed evenly and as
                unevenly as the cell moonlight_lcm_b1_10s routes (the
                busiest expert 74 of 128 tokens), bf16 against the plain
                per-expert loop (mean error against the f32 walk <= 1.02x
                the plain loop's, 4 launches a call), ms, device ms, the
                bound from the inputs and the plain loop's ms
  5. generate — the LCM serving pipeline at full width (random weights from
                a seed): batch 1 f32 with the fused stage against the
                unfused vocoder (before the final tanh); then the batch-8
                10 s generate with the launch counts of its path (K1 2, K5
                73, K6 72; every later phase holds K5 to one launch per
                activation, and K6 to one per resblock conv of the unfused
                stages, of each no-grad bf16 vocoder forward on the card), ms per
                generate, x realtime and a per-layer breakdown; the same
                generate with use_flash=True (launch counts, ms); then the
                serving vocoder at knob 96 against knob 48 (`knob`); the
                native checkpoint (`native_ckpt`: the bf16 serving pipeline
                saved and loaded into fresh modules, its generate bit for
                bit, save / load seconds, bytes on disk)
  6. teacher  — one full-width DiT forward at CFG batch 4 in f32, flash
                against einsum attention, and in bf16, flash and einsum each
                against the f32 einsum eps; then the teacher path: batch-8
                10 s DDIM-100 generate with guidance 5 and flash attention
                (DiT batch 16), its launch counts, ms, breakdown and
                profile, and a PLMS-25 generate's launch counts; the same
                DDIM-100 generate with the Flag DiT at Lumina-T2X's 2B
                widths in its place (`flag_teacher`: K3 4800 launches, 2400
                of them cross, ms, peak GB)
  7. prewarm  — api.prewarm_buckets: the serving generate captured as CUDA
                graphs at batch 8 (mel 312, 624, 1248) and batch 1 (624):
                capture seconds and pool bytes per bucket, the replay
                against the eager waveform, replay and eager ms with busy
                ms and idle share, K1's launches per replay from the
                device trace; then distill and teacher_train (one step on
                the card against the CPU, 5 steps of Trainer.fit, a
                checkpoint restored bit-exactly, ms per step)
  8. interior — the stage-interior profiler (audiolcm_torch.tools.
                profile_stage_interior) at both serving shapes, one line per
                row, with the launch counts of that run: K1 variants and the
                activation chain K4 (checked and timed in phases 3-4)
  9. vocode   — the log-mel of a 10 s wav on the card against the CPU; the
                vocoder_infer CLI at full width (random generator file +
                config.json in a temp dir) in mel mode on one 10 s mel, and
                in wav mode on one 10 s wav
 10. roundtrip— a full-width f32 VAE encode on the card against the CPU; the
                reconstruct CLI's roundtrip() at batch 8, 10 s
 11. train    — the training line at the shipped widths, f32, TF32 off, K1
                and K3 launched 0 times in each: ddp (after teacher_train:
                one LCM step with the student in DDP over a group of one on
                NCCL against the unwrapped step), train_vae (the VAE GAN of
                configs/autoencoder1d.yaml: one step card vs CPU, ms per
                step at batch 4, one CLI epoch), train_cli (the training
                CLI on configs/teacher.yaml and configs/audiolcm.yaml with
                fresh parts and stub tokenizers), train_vocoder (the vocoder
                GAN at batch 2 card vs CPU, 5 steps at batch 32); fsdp
                (after ddp: the LCM step with the student and target under
                FSDP2 in a group of one against the plain step, ms and peak
                GB of each); then error_budget (the batch-8 10 s generate
                with each serving knob alone and all of them against the f32
                exact path: K1 on its f32 and bf16 routes, K3 on both, max
                and mean |dwav| and before the tanh, each stage's distance,
                launch counts; bf16 under an absolute bar that flags the
                same path with weights rounded 4x coarser)
 12. variants — the VAE loss variants multiw, dis, mask and vq at
                configs/autoencoder1d.yaml's widths (train_vae_variants:
                one step card vs CPU, ms per step at batch 4, share of the
                f32 bound, peak GB), one CLI epoch of contperceptual_dis
                (train_vae_variants_cli); 0 K1 / K3 launches
 13. eval     — the scorers at full width, each card vs CPU (eval: LPAPS,
                MR-STFT, VGGish + FAD, the CLAP score of 60 clips), and
                cli.eval_acceptance end to end on a full-width synthetic
                checkpoint with random CLAP and VGGish files (eval_cli);
                0 K1 / K3 launches
 14. variant  — the variant modules at full width, each card vs CPU with
                its ms (variant_models: ConcatDiT, ConcatOrderDiT(2),
                TxtFlagLargeDiT, the 2D KL VAE and the VQ model, the
                trainable text encoder), and the auxiliary LDM trainers
                (ldm_variants: the inpaint, order and classifier steps card
                vs CPU, ms per step, peak GB and f32 bound; the noisy
                accuracy sweep); 0 K1 / K3 launches
 15. open_clap— the LAION CLAP at full width, each case card vs CPU with
                its ms, FLOP and share of the f32 bound: both LAION
                embedders from their registry nodes (per-token (8, 77)
                and sentence (8, 512) encodes with padded masks), the
                HTSAT-tiny aff_2d tower on 8 ten-second waveforms and on a
                mel_fusion stack (the 6-tuple forward), PANN-14's audio
                embedding; the image-CLIP towers RN50 and ViT-B-32 on
                (8, 3, 224, 224) images; 0 K1 / K3 launches
 16. micro    — the trainer convergence runs (tools/train_micro.py), card
                vs CPU over their first MICRO_STEPS steps from the same
                weights and draws: the VAE GAN, the vocoder GAN on a tone,
                teacher + LCM distillation, every metric at TRAIN_RTOL;
                0 K1 / K3 / K4 launches
 17. moonlight_generate — the batch-1 10 s LCM generate with
                Moonlight-16B-A3B as its third caption tower at full width,
                captured, the launch counts of one replay and of one eager
                generate (K7 104, K1 2, K5 73, K6 72), the replay against
                the eager waveform, ms, peak GB
then the seconds of each phase, the kernels line and, last, the device
line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time

import torch

KS, DS = (3, 7, 11), (1, 3, 5)
F32_TOL = 1e-4  # f32 kernel vs plain: same math, sums in another order
WAV_TOL = 1e-4  # batch-1 f32 pre-tanh waveform, fused stage vs unfused vocoder
FLASH_TOL = 2e-5  # K3 f32 vs plain: the JAX bar (tests/test_pallas_attention.py:26)
K5_F32_TOL = 1e-5  # K5 f32 vs plain: one activation, its sums in another order
# K3 cases at the Flag teacher's shapes: (CFG batch 16, 32 heads, 312
# latent tokens, head 72) self-attention, and the caption branch over the
# 154 caption tokens (check_flash_phase's case form)
FLAG_SELF = ((16, 32, 312, 72), False, "tc_vec")
FLAG_CROSS = ((16, 32, 312, 72), False, "tc_vec", 154)
DIT_TOL = 1e-4  # f32 DiT eps, flash vs einsum: attention sums in another order, 4 blocks
# f32 VAE moments, card vs CPU, relative to max|moments|: ~20 convs and one
# softmax attention summed in another order by cuDNN and the CPU kernels
MOMENTS_REL_TOL = 1e-3
# f32 log-mel of a tone in noise, card vs CPU: cuFFT against the CPU's FFT
# and the filterbank sums in another order (every bin far above the floor)
MEL_TOL = 1e-3
PROFILE_BATCH = 8  # the stage-interior profiler's batch (profile_shape)
ACT_FLOP = 78  # per sample and activation: up-FIR 24, two snakes ~30, down-FIR 24
GUIDANCE = 5.0
PEAK_BF16 = 989e12  # H100 SXM dense bf16 rate (published peak, 700 W)
HBM = 3.35e12  # H100 SXM memory rate, bytes/s
PEAK_F32 = 67e12  # H100 SXM float32 rate outside the tensor cores, FLOP/s
# bf16 generate, CUDA-graph replay vs eager from one generator seed: the same
# kernels on the same inputs; cuBLAS may pick other algorithms in a capture
REPLAY_TOL = 1e-3
TRAIN_RTOL = 1e-4  # f32 training step: loss card vs CPU; the update's floor (L2 vs f64)
VAE_SGD_LR = 1e-6  # the VAE GAN parity step's SGD rate: updates ~1e-2 of O(0.05) weights
TEXT_TOL = 1e-4  # f32 LAION text encodes, card vs CPU: 12 roberta layers summed in another order
AUDIO_REL_TOL = 1e-4  # f32 LAION audio towers, card vs CPU, relative to each output's scale
VISION_REL_TOL = 1e-4  # f32 image-CLIP towers, card vs CPU, relative to the output's scale
# f32 waveform, fast_snake alone vs exact cos: fast_cos is <= 5e-7 per
# activation (audiolcm_torch/nn/snake.py), over ~100 activations with residuals
FAST_SNAKE_TOL = 1e-3
# all serving knobs' mean |dwav| over bf16 alone's: the kernels and the
# polynomial add at most 10 % to bf16's own error
ALL_KNOBS_RATIO = 1.10
# bf16 serving generate alone, mean |dwav| against the exact path at full
# width: 1.10x its reading of 0.01423 (NVIDIA H100 80GB HBM3, 700 W), the
# room ALL_KNOBS_RATIO gives the kernels; the bar must flag the same path
# with weights rounded 4x coarser (0.01863 in the same run)
BF16_MEAN_TOL = 0.0157
MICRO_STEPS = 5  # train_micro's runs, card vs CPU: steps of each


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def stage_params(c: int, seed: int, device, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    out = []
    for k in KS:
        subs = []
        for _ in DS:
            s = {n: torch.exp(0.3 * torch.randn(c, generator=g)) for n in ("a1", "b1", "a2", "b2")}
            s.update({n: 0.1 * torch.randn(c, generator=g) for n in ("c1b", "c2b")})
            s.update({n: torch.randn(c, c, k, generator=g) / (c * k) ** 0.5 for n in ("w1", "w2")})
            subs.append({n: v.to(device=device, dtype=dtype) for n, v in s.items()})
        out.append({"sub": subs})
    return out


def cast(sp, dtype):
    return [{"sub": [{n: v.to(dtype) for n, v in s.items()} for s in b["sub"]]} for b in sp]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def event_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stage_bound_ms(b: int, t: int, c: int, elem_bytes: int) -> tuple:
    """Least time for one fused stage in `elem_bytes`-wide floats: bytes (x
    read once, out written once, conv weights, biases and snake parameters
    once) over the HBM rate vs operations over the bf16 peak — the convs'
    252*C^2 FLOP/sample plus the 18 activations' ~60 FLOP/sample/channel
    (up-FIR 24, two snakes ~12, down-FIR 24; the cos not counted)."""
    n = b * t
    n_sub = len(KS) * len(DS)
    weights = 2 * len(DS) * sum(KS) * c * c + 6 * n_sub * c
    t_bytes = (2 * n * c + weights) * elem_bytes / HBM
    t_ops = (252 * c * c + 18 * 60 * c) * n / PEAK_BF16
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def card_phase(device) -> dict:
    if device.type != "cuda":
        return {"name": "cpu-rehearsal", "count": 0, "nvidia_smi": "not measured"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    return {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "nvidia_smi": smi}


def ptxas_kernels(log: str) -> dict:
    """{kernel symbol: registers and spill bytes} from nvcc's `-Xptxas -v`
    log of one source."""
    out, fn = {}, None
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            fn = out.setdefault(m[1], {})
        elif fn is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                                                r"loads", ln)):
            fn.update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif fn is not None and (m := re.search(r"Used (\d+) registers", ln)):
            fn["registers"] = int(m[1])
    return out


def build_phase() -> dict:
    """Build every source; ptxas' per-kernel lines; the HMMA (tensor-core
    mma) count in the SASS of each flash-attention kernel: > 0 for every
    bf16 tensor-core instantiation (K3's tc_kernel); the HGMMA (warpgroup
    mma) count of each AMP-stage kernel, > 0 in every bf16 instantiation
    (K1's mma_kernel), and 0 tensor-core instructions of either kind in
    K1's f32 CUDA-core one; the HGMMA count of each K6 tile: > 0."""
    from audiolcm_torch.build import build_all, sass_op_counts

    t0 = time.time()
    logs = build_all()
    seconds = round(time.time() - t0, 1)
    keys = ("entry function", "registers", "spill", "smem")
    stats = {k: [ln.strip() for ln in v.splitlines() if any(w in ln for w in keys)]
             for k, v in logs.items()}
    hmma = sass_op_counts("flash_attention", "HMMA")
    amp = sass_op_counts("amp_stage", "HGMMA")
    amp_hmma = sass_op_counts("amp_stage", "HMMA")
    from audiolcm_torch.nn import act_chain as K

    row = {"seconds": seconds, "ptxas": stats, "flash_attention_sass_hmma": hmma,
           "amp_stage_sass_hgmma": amp, "amp_stage_sass_hmma": amp_hmma,
           "amp_stage_ptxas": ptxas_kernels(logs["amp_stage"]),
           "act_chain_ptxas": ptxas_kernels(logs["act_chain"]),
           "act_chain_dynamic_smem_bytes": K.smem_bytes(K.pick_tile(2), 2)}
    row["wide_conv_sass_hgmma"] = hgmma = sass_op_counts("wide_conv", "HGMMA")
    tc = [n for fn, n in hmma.items() if "tc_kernel" in fn]
    mma = [n for fn, n in amp.items() if "mma_kernel" in fn]
    cuda_core = [amp[fn] + amp_hmma[fn] for fn in amp if "mma_kernel" not in fn]
    if (not tc or min(tc) == 0 or not mma or min(mma) == 0 or not cuda_core or any(cuda_core)
            or len(hgmma) != 4 or min(hgmma.values()) == 0):
        emit({"phase": "build", **row})
        raise AssertionError(f"HMMA in SASS: flash_attention {hmma}; HGMMA in amp_stage {amp} "
                             f"(HMMA {amp_hmma}); HGMMA in wide_conv {hgmma}")
    return row


def amp_counts() -> tuple:
    """The recorder's AMP-stage launch totals: (f32 route, tensor-core route)."""
    from audiolcm_torch import obs

    c = obs.counters()
    return c.get("amp_stage.f32", 0), c.get("amp_stage.mma", 0)


def route_row(x: torch.Tensor, ks, ds, n0: tuple, n1: tuple, n2: tuple, on_card: bool,
              per_call: int = 1) -> tuple:
    """The routes and tiles of an f32 call (amp_counts() n0 -> n1) and a
    bf16 call (n1 -> n2) of one AMP-stage wrapper, their launches [f32,
    mma] and whether they are as expected: on the card the f32 call adds
    `per_call` to `amp_stage.f32` and the bf16 call as many to
    `amp_stage.mma`; the CPU launches nothing."""
    from audiolcm_torch.nn import amp_stage as A

    c = x.shape[-1]
    f32_step = [b - a for a, b in zip(n0, n1)]
    bf16_step = [b - a for a, b in zip(n1, n2)]
    b, t = x.shape[:2]
    sms = A._sms(x.device.index or 0) if on_card else A.NUM_SMS
    row = {"f32_route": A.pick_route(x), "f32_tile": A.route_tile("cuda_core", c, ks, ds, b, t),
           "bf16_route": A.pick_route(x.bfloat16()),
           "bf16_tile": A.route_tile("mma", c, ks, ds, b, t, sms),
           "launches_f32_call": f32_step, "launches_bf16_call": bf16_step}
    n = per_call if on_card else 0
    return row, f32_step == [n, 0] and bf16_step == [0, n]


def bf16_regions(kb: torch.Tensor, pb: torch.Tensor, plain: torch.Tensor, tile: int) -> dict:
    """Mean error against the f32 plain result (B, T, C) of the bf16 kernel
    output kb and of the plain bf16 path pb, [kernel, plain], over the first
    and last 256 samples and over the bf16 route's last tile (ragged where
    tile does not divide T): the edge code that a whole-tensor mean hides."""
    t = plain.shape[1]
    spans = {"first_256": (0, min(256, t)), "last_256": (max(t - 256, 0), t),
             "last_tile": ((t - 1) // tile * tile, t)}
    err = lambda y, lo, hi: (y[:, lo:hi] - plain[:, lo:hi]).abs().mean().item()
    return {name: [err(kb, lo, hi), err(pb, lo, hi)] for name, (lo, hi) in spans.items()}


def regions_hold(regions: dict) -> bool:
    return all(k <= p * 1.02 for k, p in regions.values())


def stage_kernel(rehearsal: bool, ks=KS, ds=DS):
    """K1 as the vocoder calls it, f(x, stage params, fast): the stage's
    parameters packed for x's kernel (`pack_stage`), then one launch; in a
    CPU rehearsal the kernel's algorithm in torch (`stage_tiles_emulated`)."""
    from audiolcm_torch.nn import amp_stage as A

    if rehearsal:
        return lambda x, sp, fast: A.stage_tiles_emulated(x, sp, ks, ds, fast)
    return lambda x, sp, fast: A.fused_amp_stage(
        x, A.pack_stage(sp, ks, ds, x.dtype, x.device), ks, ds, fast=fast)


def check_phase(device, cases, rehearsal: bool) -> list:
    """K1 against its plain version at each (batch, C, T): f32 on the
    CUDA-core kernel (whole, first and last 256 samples) and bf16 on the
    tensor-core kernel (mean error vs the f32 plain result, at most 1.02x
    the plain bf16 path's, over the whole output and over each of
    `bf16_regions`), with each call's route, tile and launch counts."""
    from audiolcm_torch.nn import amp_stage as A

    kernel = stage_kernel(rehearsal)
    results = []
    for batch, c, t in cases:
        sp = stage_params(c, seed=c, device=device)
        x = torch.randn(batch, c, t, generator=torch.Generator(device).manual_seed(t),
                        device=device).transpose(1, 2)
        for fast in (False, True):
            plain = A.fused_amp_stage_plain(x, sp, KS, DS, fast)
            n0 = amp_counts()
            out = kernel(x, sp, fast)
            sync(device)
            n1 = amp_counts()
            err = (out - plain).abs()
            edge = max(err[:, :256].max().item(), err[:, -256:].max().item())
            spb, xb = cast(sp, torch.bfloat16), x.bfloat16()
            kb = kernel(xb, spb, fast).float()
            sync(device)
            n2 = amp_counts()
            pb = A.fused_amp_stage_plain(xb, spb, KS, DS, fast).float()
            kerr, perr = (kb - plain).abs().mean().item(), (pb - plain).abs().mean().item()
            routes, counted = route_row(x, KS, DS, n0, n1, n2, not rehearsal)
            regions = bf16_regions(kb, pb, plain, routes["bf16_tile"])
            row = {"C": c, "T": t, "batch": batch, "fast": fast, "f32_max_abs_err": err.max().item(),
                   "f32_edge_max_abs_err": edge, "f32_tol": F32_TOL,
                   "bf16_mean_err": kerr, "plain_bf16_mean_err": perr,
                   "bf16_region_mean_err": regions,
                   "bf16_max_abs_err_vs_plain_bf16": (kb - pb).abs().max().item(), **routes}
            emit({"phase": "check", "kernel": "amp_stage", **row})
            if not (err.max().item() <= F32_TOL and edge <= F32_TOL):
                raise AssertionError(f"amp_stage f32 disagrees with its plain version: {row}")
            if not (kerr <= perr * 1.02 and regions_hold(regions)):
                raise AssertionError(f"amp_stage bf16 error above the plain bf16 path's: {row}")
            if not counted:
                raise AssertionError(f"amp_stage launch counts: {row}")
            results.append(row)
    return results


def check_variants_phase(device, shapes, rehearsal: bool) -> list:
    """K1 at every stage variant the interior profiler launches (resblock
    and dilation subsets, exact cos, accum f32: other stage radii, so other
    tiles) against the plain version on the same subset parameters, at the
    profiler's batch, with check_phase's bars and parameters: fan-in-scaled
    convs keep the output O(1), where the profiler's 0.1-scale draws grow
    it until an absolute f32 bar measures its magnitude, not the kernel."""
    from audiolcm_torch.nn import amp_stage as A
    from audiolcm_torch.tools.profile_stage_interior import STAGE_VARIANTS, subset

    rows = []
    for c, t in shapes:
        sp = stage_params(c, seed=c + 2, device=device)
        x = torch.randn(PROFILE_BATCH, c, t, generator=torch.Generator(device).manual_seed(t + 3),
                        device=device).transpose(1, 2)
        for key, (ks, ds, fast, accum) in STAGE_VARIANTS.items():
            p = subset(sp, ks, ds)
            kernel = (lambda xi, pi: A.stage_tiles_emulated(xi, pi, ks, ds, fast) if rehearsal
                      else A.fused_amp_stage(xi, A.pack_stage(pi, ks, ds, xi.dtype, xi.device),
                                             ks, ds, fast=fast, accum=accum))
            plain = A.fused_amp_stage_plain(x, p, ks, ds, fast)
            n0 = amp_counts()
            err = (kernel(x, p) - plain).abs()
            sync(device)
            n1 = amp_counts()
            edge = max(err[:, :256].max().item(), err[:, -256:].max().item())
            pb, xb = cast(p, torch.bfloat16), x.bfloat16()
            kb = kernel(xb, pb).float()
            sync(device)
            n2 = amp_counts()
            pbo = A.fused_amp_stage_plain(xb, pb, ks, ds, fast).float()
            kerr, perr = (kb - plain).abs().mean().item(), (pbo - plain).abs().mean().item()
            routes, counted = route_row(x, ks, ds, n0, n1, n2, not rehearsal)
            regions = bf16_regions(kb, pbo, plain, routes["bf16_tile"])
            row = {"C": c, "T": t, "batch": PROFILE_BATCH, "variant": key, "ks": list(ks),
                   "ds": list(ds), "fast": fast, "accum": accum,
                   "f32_max_abs_err": err.max().item(), "f32_edge_max_abs_err": edge,
                   "f32_tol": F32_TOL, "plain_abs_max": plain.abs().max().item(),
                   "bf16_mean_err": kerr, "plain_bf16_mean_err": perr,
                   "bf16_region_mean_err": regions, **routes}
            emit({"phase": "check", "kernel": "amp_stage", **row})
            if not (row["f32_max_abs_err"] <= F32_TOL and edge <= F32_TOL
                    and kerr <= perr * 1.02 and regions_hold(regions) and counted):
                raise AssertionError(f"amp_stage variant disagrees with its plain version: {row}")
            rows.append(row)
    return rows


def stage_convs(xc: torch.Tensor, sp) -> None:
    """The stage's 18 convs alone, each on xc (B, C, T) through F.conv1d
    (cuDNN): a yardstick for the tensor-core kernel's convs; no port path
    calls it."""
    import torch.nn.functional as F

    for blk, k in zip(sp, KS):
        for p, d in zip(blk["sub"], DS):
            F.conv1d(xc, p["w1"], p["c1b"], padding=(k - 1) // 2 * d, dilation=d)
            F.conv1d(xc, p["w2"], p["c2b"], padding=(k - 1) // 2)


def kernel_device_ms(run, name: str, calls: int) -> float:
    """torch.profiler device time of the kernels whose name holds `name`
    over `calls` calls of run(), per call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    return sum(us(e) for e in prof.key_averages() if name in e.key) / 1e3 / calls


def time_phase(device, cases, card: dict) -> dict:
    """K1 at the serving shapes, (batch, C, T): batch 8 of 10 s clips and
    batch 1 of a 20 s clip, bf16, fast=True, the stage's weights packed
    once (`pack_stage`), as the vocoder hands them. Kernel vs plain (CUDA
    events) and the bound; the activations' CUDA-core floor (18 alias-free
    activations at ACT_FLOP per sample over the f32 rate: a second bound,
    which the tensor cores cannot lower); the route and tile; the kernel's
    device time in the profiler (so ms - device_ms is the wrapper's cost per
    call: validation and launch); for information the stage's 18 convs
    alone through cuDNN (convs_cudnn_ms; library_ms stays null: no PyTorch
    call computes the stage)."""
    from audiolcm_torch.nn import amp_stage as A

    out = {}
    for batch, c, t in cases:
        sp = cast(stage_params(c, seed=c, device=device), torch.bfloat16)
        packed = A.pack_stage(sp, KS, DS, torch.bfloat16, device)
        x = torch.randn(batch, c, t, device=device, dtype=torch.bfloat16).transpose(1, 2)
        run = lambda: A.fused_amp_stage(x, packed, KS, DS, fast=True)
        k_ms = event_ms(run, iters=10)
        p_ms = event_ms(lambda: A.fused_amp_stage_plain(x, sp, KS, DS, True), iters=3)
        xc = x.transpose(1, 2).contiguous()
        with torch.inference_mode():
            conv_ms = event_ms(lambda: stage_convs(xc, sp), iters=5)
        bound, by = stage_bound_ms(batch, t, c, 2)
        route = A.pick_route(x)
        row = {"C": c, "T": t, "batch": batch, "route": route,
               "tile": A.route_tile(route, c, KS, DS, batch, t, A._sms(device.index or 0)),
               "ms": k_ms, "device_ms": kernel_device_ms(run, "amp_stage", 5), "plain_ms": p_ms,
               "bound_ms": bound, "bound_by": by,
               "act_f32_bound_ms": act_f32_bound_ms(batch, c, t, 2 * len(KS) * len(DS)),
               "library_ms": None, "convs_cudnn_ms": conv_ms, "card": card["nvidia_smi"]}
        row.update(bound_share=bound / row["device_ms"],
                   act_f32_bound_share=row["act_f32_bound_ms"] / row["device_ms"])
        emit({"phase": "time", "kernel": "amp_stage", **row})
        out[(batch, c, t)] = row
    return out


def act_forms_phase(device, card: dict) -> list:
    """One alias-free SnakeBeta at every stage width of a batch-8 10 s and a
    batch-1 20 s generate (the vocoder's stages: C = 768..96 unfused in
    serving, and activation_post at C = 24), bf16, fast snake, a log-scale
    SnakeBeta at the vocoder's init. Timed by CUDA events: the
    depthwise-conv form, the polyphase channels-first form, and K5
    (nn/alias_free_act.py), also by its device time; K5's bound
    (act_bound_ms: x read once and out written once over the HBM rate) and
    its f32 CUDA-core bound. K5's errors, as tests/test_torch_alias_free_act.py
    holds them: f32 max abs against the f32 plain version <= K5_F32_TOL;
    bf16 mean error against the f32 plain version (same bf16 input and
    parameters) at most 1.02x the depthwise bf16 form's; one launch per
    call of Activation1d."""
    from audiolcm_torch import obs
    from audiolcm_torch.models.bigvgan import Activation1d, BigVGANConfig
    from audiolcm_torch.nn import alias_free_act as K
    from audiolcm_torch.nn.resample import alias_free_activation_cf
    from audiolcm_torch.nn.resample_cf import alias_free_snake_cf

    cfg, rows = BigVGANConfig(fast_snake=True), []
    gen = torch.Generator().manual_seed(16)
    for batch, mel in ((8, 624), (1, 1248)):
        t = mel
        for i, u in enumerate(cfg.upsample_rates):
            c, t = cfg.upsample_initial_channel // 2 ** (i + 1), t * u
            act = Activation1d(c, cfg.activation, cfg.snake_logscale, fast=True)
            with torch.no_grad():
                for p in act.act.parameters():
                    p.copy_(0.1 * torch.randn(c, generator=gen))
            act = act.to(device=device, dtype=torch.bfloat16)
            alpha, beta = act.act.alpha, act.act.beta
            x = torch.randn(batch, c, t, device=device, dtype=torch.bfloat16)
            kernel = lambda: K.alias_free_act(x, alpha, beta, True, True)  # noqa: E731
            with torch.inference_mode():
                a_lin, b_lin = act.act.linear_params()
                row = {"C": c, "T": t, "batch": batch, "tile": K.pick_tile(t),
                       "depthwise_ms": event_ms(lambda: alias_free_activation_cf(x, act.act),
                                                iters=5),
                       "polyphase_ms": event_ms(
                           lambda: alias_free_snake_cf(x, a_lin, b_lin, fast=True), iters=5),
                       "kernel_ms": event_ms(kernel, iters=20, warmup=2),
                       "kernel_device_ms": kernel_device_ms(kernel, "alias_free_act_kernel", 20)}
                want = K.alias_free_act_plain(x.float(), alpha.float(), beta.float(), True, True)
                n0 = obs.counters().get("alias_free_act", 0)
                kb = act(x).float()
                sync(device)
                row["launches"] = obs.counters().get("alias_free_act", 0) - n0
                row["bf16_mean_err"] = (kb - want).abs().mean().item()
                row["depthwise_bf16_mean_err"] = (alias_free_activation_cf(x, act.act).float()
                                                  - want).abs().mean().item()
                row["f32_max_abs_err"] = (K.alias_free_act(
                    x.float(), alpha.float(), beta.float(), True, True) - want).abs().max().item()
            row["bound_ms"], row["bound_by"] = act_bound_ms(batch, c, t, 1, 2)
            row["f32_bound_ms"] = act_f32_bound_ms(batch, c, t, 1)
            row.update(bound_share=row["bound_ms"] / row["kernel_ms"],
                       f32_bound_share=row["f32_bound_ms"] / row["kernel_ms"],
                       f32_tol=K5_F32_TOL, card=card["nvidia_smi"])
            emit({"phase": "act_forms", **row})
            if not (row["f32_max_abs_err"] <= K5_F32_TOL and row["launches"] == 1
                    and row["bf16_mean_err"] <= 1.02 * row["depthwise_bf16_mean_err"]):
                raise AssertionError(f"alias_free_act disagrees with its plain version: {row}")
            rows.append(row)
            del x, want, kb
    return rows


def wide_conv_forms_phase(device, card: dict) -> list:
    """K6 (nn/wide_conv.py) at every unfused stage of a batch-8 10 s and a
    batch-1 20 s generate (C = 768..96), bf16: the stage's 18 resblock convs
    as the stage launches them (convs1 plain; convs2 with the residual; each
    resblock's last also with the running sum, the stage's last scaled by
    1/3), timed by CUDA events and by K6's device time, against the same 18
    convs through cuDNN (F.conv1d on channels-first bf16) with the bf16 sums
    K6 replaces; the bound 252 C^2 B T FLOP at the bf16 peak. Errors against
    an f32 reference from the same bf16 inputs (TF32 off), on the stage's
    last conv (the most sums) and on a plain one: K6's mean error at most
    1.02x the cuDNN route's, as tests/test_torch_wide_conv.py holds it; one
    launch per call."""
    import torch.nn.functional as F

    from audiolcm_torch import obs
    from audiolcm_torch.models.bigvgan import BigVGANConfig
    from audiolcm_torch.nn import wide_conv as W

    cfg, rows = BigVGANConfig(), []
    ks, ds, nk = cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes[0], 3
    for batch, mel in ((8, 624), (1, 1248)):
        t = mel
        for i, u in enumerate(cfg.upsample_rates[:4]):
            c, t = cfg.upsample_initial_channel // 2 ** (i + 1), t * u
            g = torch.Generator(device).manual_seed(c + batch)
            a, x, acc = (torch.randn(batch, c, t, generator=g, device=device).bfloat16()
                         for _ in range(3))
            ws = {k: (torch.randn(c, c, k, generator=g, device=device) * (c * k) ** -0.5)
                  .bfloat16() for k in ks}
            wp = {k: W.pack_weight(w) for k, w in ws.items()}
            bias = (0.1 * torch.randn(c, generator=g, device=device)).bfloat16()

            def k6():
                for n, k in enumerate(ks):
                    for j, d in enumerate(ds):
                        last = j == len(ds) - 1
                        W.wide_conv(a, wp[k], bias, d)
                        W.wide_conv(a, wp[k], bias, 1, res=x, acc=acc if last and n else None,
                                    scale=1 / nk if last and n == nk - 1 else 1.0)

            def cudnn():
                for n, k in enumerate(ks):
                    for j, d in enumerate(ds):
                        last = j == len(ds) - 1
                        F.conv1d(a, ws[k], bias, padding=(k - 1) // 2 * d, dilation=d)
                        h = x + F.conv1d(a, ws[k], bias, padding=(k - 1) // 2)
                        if last and n:
                            h = acc + h
                        if last and n == nk - 1:
                            h = h / nk

            with torch.inference_mode():
                row = {"C": c, "T": t, "batch": batch, "tile": W.pick_tile(c, batch, t),
                       "convs": 18, "k6_ms": event_ms(k6, iters=10, warmup=2),
                       "k6_device_ms": kernel_device_ms(k6, "wide_conv_kernel", 5),
                       "cudnn_ms": event_ms(cudnn, iters=5, warmup=2)}
                errs = {}
                for name, d, kw in (("plain", 5, {}),
                                    ("last", 1, {"res": x, "acc": acc, "scale": 1 / nk})):
                    k = 11
                    pad = (k - 1) // 2 * d
                    ref = F.conv1d(a.float(), ws[k].float(), bias.float(), padding=pad,
                                   dilation=d)
                    lib = F.conv1d(a, ws[k], bias, padding=pad, dilation=d)
                    if kw:
                        ref = (acc.float() + x.float() + ref) / nk
                        lib = (acc + (x + lib)) / nk
                    n0 = obs.counters().get("wide_conv", 0)
                    got = W.wide_conv(a, wp[k], bias, d, **kw)
                    sync(device)
                    errs[name] = {"launches": obs.counters().get("wide_conv", 0) - n0,
                                  "k6_mean_err": (got.float() - ref).abs().mean().item(),
                                  "cudnn_mean_err": (lib.float() - ref).abs().mean().item()}
            row["errors"] = errs
            row["bound_ms"] = 252 * c * c * batch * t / PEAK_BF16 * 1e3
            row.update(bound_share=row["bound_ms"] / row["k6_device_ms"], card=card["nvidia_smi"])
            emit({"phase": "wide_conv_forms", **row})
            if not all(e["launches"] == 1 and e["k6_mean_err"] <= 1.02 * e["cudnn_mean_err"]
                       for e in errs.values()):
                raise AssertionError(f"wide_conv: error above the cuDNN route's: {row}")
            rows.append(row)
            del a, x, acc, ws, wp
    return rows


def check_k2_phase(device, shapes, rehearsal: bool) -> list:
    """K2a (fused_amp_stage_tc) and K2b (fused_amp_stage_cl), one launch of
    the K1 kernels per batch element, against the plain version: batch 2,
    f32 max abs error and bf16 mean errors (whole and `bf16_regions`) as in
    check_phase, with the routes, tiles and launch counts (2 per call on the
    card)."""
    from audiolcm_torch.nn import amp_stage as A

    rows = []
    for c, t in shapes:
        sp = stage_params(c, seed=c + 1, device=device)
        x = torch.randn(2, c, t, generator=torch.Generator(device).manual_seed(t + 1),
                        device=device).transpose(1, 2)
        plain = A.fused_amp_stage_plain(x, sp, KS, DS, True)
        spb, xb = cast(sp, torch.bfloat16), x.bfloat16()
        pb = A.fused_amp_stage_plain(xb, spb, KS, DS, True).float()
        perr = (pb - plain).abs().mean().item()
        for name, fn in (("amp_stage_tc", A.fused_amp_stage_tc),
                         ("amp_stage_cl", A.fused_amp_stage_cl)):
            n0 = amp_counts()
            err = (fn(x, A.pack_stage(sp, KS, DS, x.dtype, device), KS, DS, fast=True)
                   - plain).abs().max().item()
            n1 = amp_counts()
            kb = fn(xb, A.pack_stage(spb, KS, DS, xb.dtype, device), KS, DS, fast=True).float()
            kerr = (kb - plain).abs().mean().item()
            sync(device)
            routes, counted = route_row(x, KS, DS, n0, n1, amp_counts(), not rehearsal,
                                        per_call=2)
            regions = bf16_regions(kb, pb, plain, routes["bf16_tile"])
            row = {"kernel": name, "C": c, "T": t, "batch": 2, "f32_max_abs_err": err,
                   "f32_tol": F32_TOL, "bf16_mean_err": kerr, "plain_bf16_mean_err": perr,
                   "bf16_region_mean_err": regions, **routes}
            emit({"phase": "check", **row})
            if not (err <= F32_TOL and kerr <= perr * 1.02 and regions_hold(regions)
                    and counted):
                raise AssertionError(f"{name} disagrees with the plain version: {row}")
            rows.append(row)
    return rows


def flash_inputs(shape, device, qkv_views: bool, seed: int, tk=None):
    """q (B, H, T, D), k and v (B, H, Tk, D) f32 (Tk = T unless given):
    independent draws in the DiT's head-split layout ((B, T, H, D)
    storage), or chunk views of one to_qkv output (self-attention only)."""
    b, h, t, d = shape
    g = torch.Generator(device).manual_seed(seed)
    if qkv_views:
        qkv = torch.randn(b, t, 3 * h * d, generator=g, device=device)
        return [a.reshape(b, t, h, d).transpose(1, 2) for a in qkv.chunk(3, dim=-1)]
    return [torch.randn(b, n, h, d, generator=g, device=device).transpose(1, 2)
            for n in (t, tk or t, tk or t)]


def check_flash_phase(device, cases) -> list:
    """K3 against its plain version: f32 (the CUDA-core kernel) max abs
    error <= FLASH_TOL; bf16 (the tensor-core kernel, on the route each case
    names) mean error against the f32 plain result at most 1.02x the plain
    bf16 path's. A case is (shape, qkv chunk views, bf16 route) for
    self-attention, with a fourth entry Tk for cross-attention. On the card
    each f32 call adds one to `flash_attention.f32`, each bf16 call one to
    `flash_attention.tc`, and each call of a cross case one more to
    `flash_attention.cross`."""
    from audiolcm_torch import obs
    from audiolcm_torch.nn import flash_attention as FA

    on_card = device.type == "cuda"
    counts = lambda: [obs.counters().get(k, 0) for k in ("flash_attention.f32",
                                                         "flash_attention.tc", FA.CROSS_COUNTER)]
    step = lambda a, b: [y - x for x, y in zip(a, b)]
    rows = []
    for i, (shape, views, route, *cross) in enumerate(cases):
        tk = cross[0] if cross else shape[2]
        q, k, v = flash_inputs(shape, device, views, seed=100 + i, tk=tk)
        scale = shape[-1] ** -0.5
        plain = FA.flash_attention_plain(q, k, v, scale)
        n0 = counts()
        err = (FA.flash_attention(q, k, v, scale) - plain).abs().max().item()
        n1 = counts()
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        kb16 = FA.flash_attention(qb, kb, vb, scale).float()
        n2 = counts()
        pb16 = FA.flash_attention_plain(qb, kb, vb, scale).float()
        kerr = (kb16 - plain).abs().mean().item()
        perr = (pb16 - plain).abs().mean().item()
        sync(device)
        row = {"kernel": "flash_attention", "shape": list(shape), "tk": tk,
               "qkv_chunk_views": views, "f32_route": FA.pick_route(q, k, v), "bf16_route": FA.pick_route(qb, kb, vb),
               "f32_max_abs_err": err, "f32_tol": FLASH_TOL, "bf16_mean_err": kerr,
               "plain_bf16_mean_err": perr,
               "bf16_max_abs_err_vs_plain_bf16": (kb16 - pb16).abs().max().item(),
               "launches_f32_call": step(n0, n1), "launches_bf16_call": step(n1, n2)}
        emit({"phase": "check", **row})
        c = int(tk != shape[2])
        want = ([1, 0, c], [0, 1, c]) if on_card else ([0, 0, 0], [0, 0, 0])
        if not (err <= FLASH_TOL and kerr <= perr * 1.02 and row["bf16_route"] == route
                and (row["launches_f32_call"], row["launches_bf16_call"]) == want):
            raise AssertionError(f"flash_attention disagrees with its plain version: {row}")
        rows.append(row)
    return rows


def time_k2_phase(device, shapes, card: dict) -> dict:
    """K2a and K2b at batch 8, bf16, fast snake (8 launches per call), the
    stage's weights packed once (`pack_stage`)."""
    from audiolcm_torch.nn import amp_stage as A

    out = {}
    for c, t in shapes:
        sp = cast(stage_params(c, seed=c, device=device), torch.bfloat16)
        x = torch.randn(8, c, t, device=device, dtype=torch.bfloat16).transpose(1, 2)
        packed = A.pack_stage(sp, KS, DS, torch.bfloat16, device)
        for name, fn in (("amp_stage_tc", A.fused_amp_stage_tc),
                         ("amp_stage_cl", A.fused_amp_stage_cl)):
            ms = event_ms(lambda: fn(x, packed, KS, DS, fast=True), iters=3)
            emit({"phase": "time", "kernel": name, "C": c, "T": t, "batch": 8, "ms": ms,
                  "card": card["nvidia_smi"]})
            out[(name, c, t)] = ms
    return out


def flash_bound_ms(b: int, h: int, t: int, d: int, elem_bytes: int, tk=None) -> tuple:
    """Least time for one attention of T queries over Tk keys (Tk = T unless
    given): q, k, v read once and the output written once over the HBM
    rate, B*H*D*(2T + 2Tk) elements, vs 4*B*H*T*Tk*D FLOP (two T x Tk x D
    products) over the bf16 peak."""
    tk = tk or t
    t_bytes = b * h * d * (2 * t + 2 * tk) * elem_bytes / HBM
    t_ops = 4 * b * h * t * tk * d / PEAK_BF16
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def time_flash_phase(device, shape, card: dict, tk=None) -> dict:
    """K3 at one DiT shape in bf16 (CUDA events, inputs in the DiT's
    head-split layout; Tk keys for cross-attention): the kernel, its plain
    version, the library's scaled_dot_product_attention (a yardstick only:
    the port never calls it) and the bound."""
    import torch.nn.functional as F

    from audiolcm_torch.nn import flash_attention as FA

    q, k, v = (a.bfloat16() for a in flash_inputs(shape, device, False, seed=7, tk=tk))
    scale = shape[-1] ** -0.5
    row = {"shape": list(shape), "tk": tk or shape[2], "dtype": "bfloat16",
           "route": FA.pick_route(q, k, v),
           "ms": event_ms(lambda: FA.flash_attention(q, k, v, scale), iters=50, warmup=3),
           "plain_ms": event_ms(lambda: FA.flash_attention_plain(q, k, v, scale), iters=20,
                                warmup=2),
           "library_ms": event_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                                  iters=50, warmup=3)}
    row["bound_ms"], row["bound_by"] = flash_bound_ms(*shape, 2, tk=tk)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["card"] = card["nvidia_smi"]
    emit({"phase": "time", "kernel": "flash_attention", **row})
    return row


def act_params(c: int, device) -> tuple:
    """The profiler's act-row snake parameters: alpha 0.3 (in bf16), beta 1."""
    from audiolcm_torch.tools.profile_stage_interior import ALPHA, BETA

    return (torch.full((c,), ALPHA, device=device).bfloat16(),
            torch.full((c,), BETA, device=device))


def check_act_phase(device, shapes, rehearsal: bool) -> list:
    """K4 against its plain version at the profiler's parameters and batch,
    n_rep 1, 2, 6 and the longest chain the wrapper takes (MAX_NREP), fast
    off and on: f32 max abs error (whole, and the first and last
    halo(n_rep) samples) <= F32_TOL; bf16 mean error against the f32 plain
    result at most 1.02x the plain bf16 chain's; one launch per call."""
    from audiolcm_torch import obs
    from audiolcm_torch.nn import act_chain as K

    kernel = K.act_chain_tiles_emulated if rehearsal else K.act_chain
    rows = []
    for c, t in shapes:
        x = torch.randn(PROFILE_BATCH, t, c,
                        generator=torch.Generator(device).manual_seed(t + 2), device=device)
        a, b = act_params(c, device)
        for n_rep in (1, 2, 6, K.MAX_NREP):
            for fast in (False, True):
                plain = K.act_chain_plain(x, a, b, n_rep, fast)
                before = obs.counters().get("act_chain", 0)
                err = (kernel(x, a, b, n_rep, fast) - plain).abs()
                launches = obs.counters().get("act_chain", 0) - before
                h = K.halo(n_rep)
                edge = max(err[..., :h].max().item(), err[..., -h:].max().item())
                kerr = (kernel(x.bfloat16(), a, b, n_rep, fast).float() - plain).abs().mean().item()
                perr = (K.act_chain_plain(x.bfloat16(), a, b, n_rep, fast).float()
                        - plain).abs().mean().item()
                sync(device)
                row = {"kernel": "act_chain", "C": c, "T": t, "batch": PROFILE_BATCH,
                       "n_rep": n_rep, "tile": K.pick_tile(n_rep), "launches": launches,
                       "fast": fast, "f32_max_abs_err": err.max().item(),
                       "f32_edge_max_abs_err": edge, "f32_tol": F32_TOL, "bf16_mean_err": kerr,
                       "plain_bf16_mean_err": perr}
                emit({"phase": "check", **row})
                if not (row["f32_max_abs_err"] <= F32_TOL and edge <= F32_TOL
                        and kerr <= perr * 1.02 and launches == (0 if rehearsal else 1)):
                    raise AssertionError(f"act_chain disagrees with its plain version: {row}")
                rows.append(row)
    return rows


def act_bound_ms(b: int, c: int, t: int, n_rep: int, elem_bytes: int) -> tuple:
    """Least time for one activation chain: x read once and the output
    written once over the HBM rate, vs ACT_FLOP per sample and activation
    over the bf16 peak."""
    t_bytes = 2 * b * c * t * elem_bytes / HBM
    t_ops = ACT_FLOP * n_rep * b * c * t / PEAK_BF16
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def act_f32_bound_ms(b: int, c: int, t: int, n_rep: int) -> float:
    """The same ACT_FLOP over the f32 rate of the CUDA cores: the floor of a
    chain whose cos and 6-tap FIRs cannot run on the tensor cores."""
    return 1e3 * ACT_FLOP * n_rep * b * c * t / PEAK_F32


def time_act_phase(device, shapes, card: dict) -> list:
    """K4 at the profiler's launches: its batch, bf16, fast, n_rep 2 and 6
    (CUDA events through the wrapper, and the kernel's device time in the
    profiler), its plain version, the bound, the f32 CUDA-core bound, and
    the kernel's share of each."""
    from audiolcm_torch.nn import act_chain as K

    rows = []
    for c, t in shapes:
        x = torch.randn(PROFILE_BATCH, t, c, device=device, dtype=torch.bfloat16)
        a, b = act_params(c, device)
        for n_rep in (2, 6):
            row = {"C": c, "T": t, "batch": PROFILE_BATCH, "n_rep": n_rep,
                   "ms": event_ms(lambda: K.act_chain(x, a, b, n_rep), iters=20, warmup=2),
                   "plain_ms": event_ms(lambda: K.act_chain_plain(x, a, b, n_rep, True), iters=3)}
            row["bound_ms"], row["bound_by"] = act_bound_ms(PROFILE_BATCH, c, t, n_rep, 2)
            row["device_ms"] = kernel_device_ms(lambda: K.act_chain(x, a, b, n_rep),
                                                "act_chain_kernel", calls=20)
            row["f32_bound_ms"] = act_f32_bound_ms(PROFILE_BATCH, c, t, n_rep)
            row.update(bound_share=row["bound_ms"] / row["ms"],
                       f32_bound_share=row["f32_bound_ms"] / row["ms"], tile=K.pick_tile(n_rep),
                       library_ms=None, card=card["nvidia_smi"])
            emit({"phase": "time", "kernel": "act_chain", **row})
            rows.append(row)
    return rows


def init_random_(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Fan-in-scaled normal weights, norm scales ~1, small biases and
    log-scale snake parameters: finite activations at every width. The
    vocoder's signal grows ~1.5x per stage under this init, so its output
    conv is scaled by 0.01 to keep the final tanh out of saturation."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                gain = 0.01 if name == "conv_post.weight" else 1.0
                p.normal_(0.0, gain * p[0].numel() ** -0.5, generator=gen)
            elif name.endswith(("alpha", "beta")):
                p.normal_(0.0, 0.1, generator=gen)
            elif name.endswith("weight"):
                p.normal_(1.0, 0.02, generator=gen)
            else:
                p.normal_(0.0, 0.02, generator=gen)


def build_modules(device, full: bool, fast_snake: bool = True):
    from audiolcm_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from audiolcm_torch.models.clap_text import BertConfig, ClapTextEncoder
    from audiolcm_torch.models.dit import ConcatDiT2MLP
    from audiolcm_torch.models.t5_encoder import T5Config, T5Encoder
    from audiolcm_torch.models.vae1d import AutoencoderKL1D, VAEConfig
    from audiolcm_torch.pipeline import PipelineModules

    if full:  # the shipped widths (configs/audiolcm.yaml, the 16 kHz vocoder)
        bert, t5, dit, vae, voc = (BertConfig(), T5Config(), {}, VAEConfig(),
                                   BigVGANConfig(fast_snake=fast_snake))
    else:  # rehearsal: same structure, tiny widths
        bert = BertConfig(vocab_size=100, hidden_size=16, num_layers=1, num_heads=2,
                          intermediate_size=32, max_position_embeddings=80)
        t5 = T5Config(vocab_size=100, d_model=32, d_kv=8, d_ff=48, num_layers=1, num_heads=2)
        dit = dict(context_dim=32, hidden_size=32, depth=1, num_heads=4)
        vae = VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1)
        voc = BigVGANConfig(upsample_initial_channel=192, fast_snake=fast_snake)
    with torch.device(device):
        mods = PipelineModules(
            dit=ConcatDiT2MLP(**dit), vae=AutoencoderKL1D(vae),
            vocoder=BigVGAN(voc, pallas_stage_max_channels=48),
            clap_text=ClapTextEncoder(bert, 1024 if full else 32, fuse_proj=True),
            t5=T5Encoder(t5, fuse_proj=True))
    gen = torch.Generator(device).manual_seed(0)
    for _, m in mods.items():
        init_random_(m, gen)
    return mods


# the recorder's launch counters (audiolcm_torch.obs), by kernel and route
COUNTERS = ("amp_stage.mma", "amp_stage.f32", "flash_attention.tc", "flash_attention.f32",
            "flash_attention.cross", "act_chain", "alias_free_act", "wide_conv", "moe_experts")
_counts_base: dict = {}
_k5_due = 0  # K5 launches owed by the eager vocoder forwards since reset_counts()
_k6_due = 0  # K6 launches owed by them


def track_k5_due() -> None:
    """Makes every BigVGAN forward add the K5 and K6 launches it owes
    (k5_launches: one per activation outside a fused stage, on the card
    without autograd; k6_launches: one per resblock conv of those stages in
    bf16) to `_k5_due` and `_k6_due`. A replayed graph runs no forward, so
    this counts eager forwards only."""
    from audiolcm_torch.models.bigvgan import BigVGAN

    forward = BigVGAN.forward

    def owing(self, mel):
        global _k5_due, _k6_due
        dtype, on_card = next(self.parameters()).dtype, mel.is_cuda and not torch.is_grad_enabled()
        _k5_due += k5_launches(self, dtype, on_card, mel.shape[1])
        _k6_due += k6_launches(self, dtype, on_card, mel.shape[1])
        return forward(self, mel)

    BigVGAN.forward = owing


def reset_counts() -> None:
    """Marks the launch totals that read_counts() counts from."""
    from audiolcm_torch import obs

    global _counts_base, _k5_due, _k6_due
    _counts_base, _k5_due, _k6_due = obs.counters(), 0, 0


def read_counts() -> dict:
    """Launches of each kernel and route since reset_counts()."""
    from audiolcm_torch import obs

    now = obs.counters()
    return {k: now.get(k, 0) - _counts_base.get(k, 0) for k in COUNTERS}


def stage_launches(vocoder, dtype, frames: int, routes: tuple) -> int:
    """Activations, one per resblock conv in resblock "1", of the stages
    whose route (`BigVGAN.stage_route`) on the card without autograd, for a
    mel of `frames`, is one of `routes`."""
    nk, card = len(vocoder.config.resblock_kernel_sizes), torch.device("cuda")
    with torch.no_grad():
        return sum(len(blk.activations) for i in range(len(vocoder.ups))
                   if vocoder.stage_route(i, dtype, card, frames) in routes
                   for blk in vocoder.resblocks[i * nk:(i + 1) * nk])


def k5_launches(vocoder, dtype, on_card: bool, frames: int) -> int:
    """K5 launches of one vocoder forward on the card without autograd: each
    activation outside a fused stage, and activation_post (73 in the serving
    vocoder, whose stages C <= 48 are fused)."""
    return 1 + stage_launches(vocoder, dtype, frames, ("wide", "torch")) if on_card else 0


def k6_launches(vocoder, dtype, on_card: bool, frames: int) -> int:
    """K6 launches of one vocoder forward on the card without autograd: each
    resblock conv of a "wide" stage (72 in the serving vocoder: 4 stages x 3
    resblocks x 6 convs)."""
    return stage_launches(vocoder, dtype, frames, ("wide",)) if on_card else 0


def counts_with(**nonzero) -> dict:
    """read_counts()'s dict with every counter 0 but these (`amp_stage_mma`
    for `amp_stage.mma`, ...)."""
    return {k: nonzero.get(k.replace(".", "_"), 0) for k in COUNTERS}


def set_flash(dit: torch.nn.Module, on: bool) -> None:
    """Switch every self-attention of the DiT between the flash path and the
    einsum path (the module reads use_flash at each forward)."""
    from audiolcm_torch.nn.attention import MultiHeadSelfAttention

    for m in dit.modules():
        if isinstance(m, MultiHeadSelfAttention):
            m.use_flash = on


def token_ids(mods, batch: int, tok: int, seed: int) -> list:
    vocab = (mods.clap_text.config.vocab_size, mods.t5.config.vocab_size)
    return [torch.randint(0, v, (batch, tok), generator=torch.Generator().manual_seed(seed + i))
            for i, v in enumerate(vocab)]


def generate_phase(device, mods, full: bool, card: dict) -> dict:
    from audiolcm_torch.pipeline import AudioLCMPipeline

    batch, latent, tok = (8, 312, 77) if full else (2, 16, 77)
    ids = token_ids(mods, batch, tok, seed=0)

    # batch 1, f32: the fused stage against the unfused vocoder, compared
    # before the final tanh so that no saturation hides a difference
    pipe = AudioLCMPipeline(mods, compute_dtype=torch.float32, device=device)
    pre_tanh, wavs = [], []
    hook = mods.vocoder.conv_post.register_forward_hook(lambda m, i, o: pre_tanh.append(o))
    for pallas in (48, 0):
        mods.vocoder.pallas_stage_max_channels = pallas
        wav, _ = pipe.generate(ids[0][:1], ids[1][:1], latent,
                               generator=torch.Generator(device).manual_seed(1))
        wavs.append(wav)
    hook.remove()
    diff = (pre_tanh[0] - pre_tanh[1]).abs().max().item()
    emit({"phase": "generate_b1_f32", "fused_vs_unfused_pre_tanh_max_abs": diff,
          "tol": WAV_TOL, "pre_tanh_abs_max": pre_tanh[1].abs().max().item(),
          "wav_abs_max": wavs[1].abs().max().item()})
    if not diff <= WAV_TOL:
        raise AssertionError(f"batch-1 f32 waveform: fused stage vs unfused differ by {diff}")
    mods.vocoder.pallas_stage_max_channels = 48

    # the main path: the serving pipeline, bf16, batch 8, 10 s clips
    pipe = AudioLCMPipeline(mods, compute_dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device).manual_seed(2)
    pipe.generate(ids[0], ids[1], latent, generator=gen)  # warm-up
    sync(device)
    reset_counts()
    wav, mel = pipe.generate(ids[0], ids[1], latent, generator=gen)
    sync(device)
    launches = read_counts()
    expect = (batch, latent * 2 * 256)
    on_card = device.type == "cuda"
    n_k5 = k5_launches(mods.vocoder, torch.bfloat16, on_card, 2 * latent)
    n_k6 = k6_launches(mods.vocoder, torch.bfloat16, on_card, 2 * latent)
    ok = (tuple(wav.shape) == expect and bool(torch.isfinite(wav).all())
          and wav.abs().max().item() <= 1.0
          and launches == counts_with(amp_stage_mma=2 if on_card else 0, alias_free_act=n_k5,
                                      wide_conv=n_k6))
    row = {"batch": batch, "wav_shape": list(wav.shape), "mel_shape": list(mel.shape),
           "finite": bool(torch.isfinite(wav).all()), "wav_abs_max": wav.abs().max().item(),
           "wav_std": wav.std().item(),
           "launches": launches}
    if not ok:
        emit({"phase": "generate", **row})
        raise AssertionError(f"main path check failed: {row}")
    if device.type == "cuda":
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            pipe.generate(ids[0], ids[1], latent, generator=gen)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / iters
        row.update(ms_per_generate=ms, x_realtime=batch * expect[1] / 16000 / (ms / 1e3),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card["nvidia_smi"])
        row["breakdown_ms"] = layer_breakdown(pipe, ids, latent, gen)
        row["profile"] = profile_run(lambda: pipe.generate(ids[0], ids[1], latent, generator=gen),
                                     ms, watch=("amp_stage",))
    else:
        row.update(ms_per_generate="not measured", x_realtime="not measured")
    # the same LCM generate with use_flash=True: its flash launches, and its
    # ms for information (the serving default stays the einsum path)
    set_flash(pipe.modules.dit, True)
    reset_counts()
    pipe.generate(ids[0], ids[1], latent, generator=gen)
    sync(device)
    row["launches_with_flash"] = read_counts()
    if on_card:
        t0 = time.perf_counter()
        for _ in range(iters):
            pipe.generate(ids[0], ids[1], latent, generator=gen)
        torch.cuda.synchronize()
        row["ms_per_generate_with_flash"] = 1e3 * (time.perf_counter() - t0) / iters
    set_flash(pipe.modules.dit, False)
    n_flash = 2 * len(pipe.modules.dit.blocks) * 2 if on_card else 0  # 2 LCM steps
    if row["launches_with_flash"] != counts_with(amp_stage_mma=2 if on_card else 0,
                                                 flash_attention_tc=n_flash,
                                                 alias_free_act=n_k5, wide_conv=n_k6):
        raise AssertionError(f"LCM generate with flash: {row['launches_with_flash']}")
    emit({"phase": "generate", **row})
    return row


def knob_phase(device, mods, full: bool) -> dict:
    """The fused-stage knob above the widest C a kernel route takes: the
    serving vocoder (bf16, fast snake) at batch 8 on a 10 s mel with
    pallas_stage_max_channels 48 and 96. At 96 the C=96 stage, which no
    route takes, runs unfused, so both knobs launch the tensor-core kernel
    for C=48 and 24 alone (2 `amp_stage.mma` each on the card) and give the
    same waveform: the same ops on the same input, cuDNN deterministic."""
    voc = mods.vocoder
    batch, frames = (8, 624) if full else (2, 16)
    gen = torch.Generator(device).manual_seed(9)
    mel = (0.5 * torch.randn(batch, frames, 80, generator=gen, device=device) - 4.0).bfloat16()
    widths = [voc.config.upsample_initial_channel >> (i + 1)
              for i in range(len(voc.config.upsample_rates))]
    wavs, row = {}, {"batch": batch, "frames": frames}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for knob in (48, 96):
            voc.pallas_stage_max_channels = knob
            reset_counts()
            with torch.inference_mode():
                wavs[knob] = voc(mel).float()
            sync(device)
            row[f"knob_{knob}"] = {"fused_widths": [
                c for i, c in enumerate(widths)
                if voc.stage_route(i, torch.bfloat16, device, frames) == "fused"],
                                   "launches_mma": read_counts()["amp_stage.mma"]}
    finally:
        voc.pallas_stage_max_channels = 48
        torch.backends.cudnn.deterministic = deterministic
    row["max_abs_diff_96_vs_48"] = (wavs[96] - wavs[48]).abs().max().item()
    want = 2 if device.type == "cuda" else 0
    emit({"phase": "knob", **row})
    if not (row["knob_96"]["launches_mma"] == row["knob_48"]["launches_mma"] == want
            and row["max_abs_diff_96_vs_48"] == 0.0
            and tuple(wavs[96].shape) == (batch, 256 * frames)
            and bool(torch.isfinite(wavs[96]).all())):
        raise AssertionError(f"fused-stage knob 96 vs 48: {row}")
    return row


def error_budget_phase(device, full: bool, card: dict) -> dict:
    """The serving error budget at full width (tests/test_torch_error_budget.py
    at the JAX package's tiny widths): the batch-8 10 s generate with each
    serving knob alone and with all of them against the exact path (f32,
    exact cos, unfused vocoder, einsum attention, TF32 off), from one set
    of random weights, ids, x_T and noise. Each row: max and mean |dwav|,
    the same before the final tanh, the rel L2 distance of each stage's
    output from the exact path's (each text tower, the context, the latent,
    the mel, the pre-tanh waveform), and the launches of its generate; the
    bf16 row also each bf16 stage alone on the exact path's input (the DiT
    on the exact context, the VAE decoder on the exact latent, the vocoder
    on the exact mel). Bars: the f32 kernel knobs (K1's CUDA-core route for
    the fused stages, K3's CUDA-core kernel) only reorder sums, max |dwav|
    <= WAV_TOL; fast_snake alone <= FAST_SNAKE_TOL; bf16 alone's mean
    |dwav| <= BF16_MEAN_TOL, which must flag the control (the bf16 path
    with every weight rounded to 5 stored mantissa bits); all knobs' mean
    |dwav| <= ALL_KNOBS_RATIO x bf16 alone's. K1 2 launches per generate
    where the stages fuse (both on its tensor-core kernel in bf16, none in
    f32), K3 16 with flash (all on its tensor-core kernel in bf16)."""
    import dataclasses

    from audiolcm_torch.models.bigvgan import BigVGAN
    from audiolcm_torch.pipeline import AudioLCMPipeline, PipelineModules

    t0 = time.time()
    on_card = device.type == "cuda"
    batch, latent, tok = (8, 312, 77) if full else (2, 16, 77)
    mods = build_modules(device, full, fast_snake=False)
    exact_voc = mods.vocoder
    with torch.device(device):
        fast_voc = BigVGAN(dataclasses.replace(exact_voc.config, fast_snake=True))
    fast_voc.load_state_dict(exact_voc.state_dict())
    ids = token_ids(mods, batch, tok, seed=40)
    g = torch.Generator(device).manual_seed(41)
    shape = (batch, latent, mods.dit.in_channels)
    x_T = torch.randn(shape, generator=g, device=device)
    noise = torch.randn((2,) + shape, generator=g, device=device)
    # each stage's output: the text context (both towers), the latent the
    # VAE decodes, the mel the vocoder takes, the vocoder's pre-tanh output
    taps = {}
    tap = lambda key: lambda m, i, o=None: taps.setdefault(key, []).append(  # noqa: E731
        (o if o is not None else i[0]).detach().float())
    hooks = [mods.clap_text.register_forward_hook(tap("context")),
             mods.t5.register_forward_hook(tap("context")),
             mods.vae.post_quant_conv.register_forward_pre_hook(tap("latent"))]
    for v in (exact_voc, fast_voc):
        hooks += [v.register_forward_pre_hook(tap("mel")),
                  v.conv_post.register_forward_hook(tap("pre_tanh"))]
    n_flash = 2 * len(mods.dit.blocks) * 2 if on_card else 0  # 2 LCM steps
    k1 = 2 if on_card else 0
    # f32 rows first: a bf16 pipeline casts the modules it holds
    knobs = {"exact": (torch.float32, False, False, False),
             "fused": (torch.float32, False, True, False),
             "flash": (torch.float32, False, False, True),
             "fast_snake": (torch.float32, True, False, False),
             "bf16": (torch.bfloat16, False, False, False),
             "all": (torch.bfloat16, True, True, True)}
    def expected(dtype, fused: bool, flash: bool) -> dict:
        tc = dtype == torch.bfloat16  # bf16 takes the tensor-core routes
        return {"amp_stage.f32": k1 * (fused and not tc), "amp_stage.mma": k1 * (fused and tc),
                "flash_attention.f32": n_flash * (flash and not tc),
                "flash_attention.tc": n_flash * (flash and tc)}

    expect = {name: expected(dtype, fused, flash)
              for name, (dtype, _, fused, flash) in knobs.items()}
    wavs, stages, rows = {}, {}, {}
    rel_l2 = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731

    def split_context(taps) -> dict:
        """The taps of one generate: each text tower's output and their
        concatenation (the DiT's context), the latent, mel and pre-tanh."""
        clap, t5 = taps["context"]
        return {"context_clap": clap, "context_t5": t5,
                "context": torch.cat([clap, t5], dim=1),
                **{k: taps[k][-1] for k in ("latent", "mel", "pre_tanh")}}

    try:
        for name, (dtype, fast, fused, flash) in knobs.items():
            voc = fast_voc if fast else exact_voc
            voc.pallas_stage_max_channels = 48 if fused else 0
            set_flash(mods.dit, flash)
            pipe = AudioLCMPipeline(dataclasses.replace(mods, vocoder=voc), compute_dtype=dtype,
                                    device=device)
            taps.clear()
            reset_counts()
            wav, _ = pipe.generate(ids[0], ids[1], latent, x_T=x_T, noise=noise)
            sync(device)
            counts = read_counts()
            wavs[name] = wav
            stages[name] = split_context(taps)
            rows[name] = {"launches": {k: counts[k] for k in expect[name]},
                          "launches_ok": {k: counts[k] for k in expect[name]} == expect[name]
                          and counts["act_chain"] == 0}
            if name == "bf16":
                # each bf16 stage alone on the exact path's input, against
                # the exact output: which stage the bf16 error comes from
                ex = stages["exact"]
                with torch.inference_mode():
                    z = pipe.sample_latent(ex["context"].to(dtype), latent, None, x_T, noise)
                    alone = {"dit": rel_l2((z.float() / pipe.scale_factor).transpose(1, 2),
                                           ex["latent"]),
                             "vae": rel_l2(pipe.modules.vae.decode(
                                 ex["latent"].transpose(1, 2).to(dtype)).float(), ex["mel"]),
                             "vocoder": rel_l2(pipe.vocode(ex["mel"].to(dtype)).float(),
                                               wavs["exact"])}
                rows[name]["rel_l2_stage_alone"] = alone
        # the control: bf16 with every weight rounded to 4x bf16's step (5
        # stored mantissa bits instead of 7); the bar must catch it
        pipe = AudioLCMPipeline(dataclasses.replace(mods, vocoder=exact_voc),
                                compute_dtype=torch.bfloat16, device=device)
        exact_voc.pallas_stage_max_channels = 0
        set_flash(mods.dit, False)
        with torch.no_grad():
            for _, m in mods.items():
                for p in m.parameters():
                    bits = p.data.view(torch.int16)
                    bits.copy_((bits + 2) & ~3)
        taps.clear()
        wavs["bf16_coarse_weights"], _ = pipe.generate(ids[0], ids[1], latent, x_T=x_T,
                                                       noise=noise)
        stages["bf16_coarse_weights"] = split_context(taps)
        rows["bf16_coarse_weights"] = {}
    finally:
        for h in hooks:
            h.remove()
        set_flash(mods.dit, False)
    wav_mean = wavs["exact"].abs().mean().item()
    for name in rows:
        d = (wavs[name] - wavs["exact"]).abs()
        dp = (stages[name]["pre_tanh"] - stages["exact"]["pre_tanh"]).abs()
        rows[name].update(max_abs_dwav=d.max().item(), mean_abs_dwav=d.mean().item(),
                          mean_abs_dwav_over_mean_abs_wav=d.mean().item() / wav_mean,
                          max_abs_dpre_tanh=dp.max().item(), mean_abs_dpre_tanh=dp.mean().item(),
                          rel_l2_by_stage={k: rel_l2(v, stages["exact"][k])
                                           for k, v in stages[name].items()})
    bars = {"fused": ("max_abs_dwav", WAV_TOL), "flash": ("max_abs_dwav", WAV_TOL),
            "fast_snake": ("max_abs_dwav", FAST_SNAKE_TOL),
            "all": ("mean_abs_dwav", ALL_KNOBS_RATIO * rows["bf16"]["mean_abs_dwav"])}
    if full:  # set at full width
        bars["bf16"] = ("mean_abs_dwav", BF16_MEAN_TOL)
    for name, (key, bar) in bars.items():
        rows[name].update(bar={key: bar}, within_bar=rows[name][key] <= bar)
    control = rows.pop("bf16_coarse_weights")
    control.update(bar_catches_it=control["mean_abs_dwav"] > BF16_MEAN_TOL or not full)
    row = {"batch": batch, "latent": latent, "rows": rows, "control": control,
           "wav_abs_max": wavs["exact"].abs().max().item(), "wav_abs_mean": wav_mean,
           "pre_tanh_abs_max": stages["exact"]["pre_tanh"].abs().max().item(),
           "finite": all(bool(torch.isfinite(w).all()) for w in wavs.values()),
           "seconds": time.time() - t0, "card": card["nvidia_smi"]}
    emit({"phase": "error_budget", **row})
    if not (row["finite"] and all(r["launches_ok"] for r in rows.values())
            and all(rows[n]["within_bar"] for n in bars) and control["bar_catches_it"]):
        raise AssertionError(f"error_budget: a knob beyond its bar or launch count, or the "
                             f"bf16 bar misses its control: {row}")
    return row


def native_ckpt_phase(device, mods, full: bool, card: dict, tmp: str) -> dict:
    """The native pipeline checkpoint (audiolcm_torch/native_ckpt.py): the
    full-width bf16 serving pipeline (fused text projections, fast snake,
    the fused stages at knob 48) saved, and loaded into fresh modules of
    the same knobs; its batch-8 10 s generate from one set of ids, x_T and
    noise before and after, bit for bit, with cuDNN deterministic (and
    twice before, the card's own repeat). The save and load seconds and
    the bytes on disk. The generate launches K1 and K5 as the serving path
    does (2, both on K1's tensor-core kernel; 73), K3 and K4 none."""
    import os

    from audiolcm_torch import native_ckpt
    from audiolcm_torch.pipeline import AudioLCMPipeline

    t0 = time.time()
    on_card = device.type == "cuda"
    batch, latent, tok = (8, 312, 77) if full else (2, 16, 77)
    ids = token_ids(mods, batch, tok, seed=50)
    g = torch.Generator(device).manual_seed(51)
    shape = (batch, latent, mods.dit.in_channels)
    x_T = torch.randn(shape, generator=g, device=device)
    noise = torch.randn((2,) + shape, generator=g, device=device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        pipe = AudioLCMPipeline(mods, compute_dtype=torch.bfloat16, device=device)
        gen = lambda p: p.generate(ids[0], ids[1], latent, x_T=x_T, noise=noise)[0]  # noqa: E731
        before, again = gen(pipe), gen(pipe)
        path = os.path.join(tmp, "native_ckpt")
        sync(device)
        t1 = time.perf_counter()
        native_ckpt.save_pipeline(path, pipe)
        save_s = time.perf_counter() - t1
        fresh = build_modules(device, full)
        sync(device)
        t1 = time.perf_counter()
        loaded = native_ckpt.load_pipeline(path, fresh, device=device)
        sync(device)
        load_s = time.perf_counter() - t1
        reset_counts()
        after = gen(loaded)
        sync(device)
        counts = read_counts()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    k1 = 2 if on_card else 0
    row = {"batch": batch, "latent": latent, "compute_dtype": str(loaded.compute_dtype),
           "bytes_on_disk": sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)),
           "save_s": save_s, "load_s": load_s, "repeat_equal": torch.equal(before, again),
           "bit_exact_after_load": torch.equal(before, after),
           "max_abs_diff_after_load": (before - after).abs().max().item(),
           "launches": counts, "seconds": time.time() - t0, "card": card["nvidia_smi"]}
    emit({"phase": "native_ckpt", **row})
    del fresh, loaded
    if not (row["repeat_equal"] and row["bit_exact_after_load"]
            and counts == counts_with(
                amp_stage_mma=k1,
                alias_free_act=k5_launches(mods.vocoder, torch.bfloat16, on_card, 2 * latent),
                wide_conv=k6_launches(mods.vocoder, torch.bfloat16, on_card, 2 * latent))):
        raise AssertionError(f"native_ckpt: the loaded pipeline differs: {row}")
    return row


def layer_breakdown(pipe, ids, latent: int, gen) -> dict:
    """CUDA-event ms of each layer of one batch-8 generate."""
    out = {}
    with torch.inference_mode():
        ctx = pipe.encode_text_ids(ids[0], ids[1])
        out["text_towers"] = event_ms(lambda: pipe.encode_text_ids(ids[0], ids[1]), 3)
        z = pipe.sample_latent(ctx, latent, gen)
        out["dit_lcm_2_steps"] = event_ms(lambda: pipe.sample_latent(ctx, latent, gen), 3)
        mel = pipe.decode_latent(z)
        out["vae_decode"] = event_ms(lambda: pipe.decode_latent(z), 3)
        out["vocoder"] = event_ms(lambda: pipe.vocode(mel), 3)
        voc = pipe.modules.vocoder
        voc.pallas_stage_max_channels = 0
        out["vocoder_unfused"] = event_ms(lambda: pipe.vocode(mel), 2)
        voc.pallas_stage_max_channels = 48
    return out


def profile_run(run, wall_ms: float, top: int = 8, watch: tuple = ()) -> dict:
    """torch.profiler over one call of run() (a generate): device busy time,
    idle share against the host-clock ms of an unprofiled call (`wall_ms`),
    the device's own idle share within the span of its events, the kernels
    that take most of the device time, and every kernel whose name holds
    one of `watch`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    self_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    # device-side events only (kernels, copies); aten ops repeat their time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and self_us(e) > 0]
    busy_ms = sum(self_us(e) for e in events) / 1e3
    events.sort(key=self_us, reverse=True)
    row = lambda e: {"name": e.key[:90], "ms": self_us(e) / 1e3, "calls": e.count,
                     "share": self_us(e) / 1e3 / busy_ms}
    # the device's own idle share: busy time over the span from the first
    # device event's start to the last one's end (no host clock in it)
    spans = [e.time_range for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    span_ms = (max(r.end for r in spans) - min(r.start for r in spans)) / 1e3 if spans else 0
    return {"device_busy_ms": busy_ms,
            "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else "not measured",
            "device_span_ms": span_ms or "not measured",
            "idle_share_in_span": (1.0 - busy_ms / span_ms) if span_ms else "not measured",
            "top_kernels": [row(e) for e in events[:top]],
            "watched": [row(e) for e in events if any(w in e.key for w in watch)]}


def dit_kwargs(full: bool) -> dict:
    """The shipped ConcatDiT2MLP (configs/audiolcm.yaml, configs/teacher.yaml)
    or the rehearsal's tiny one."""
    return {} if full else dict(context_dim=32, hidden_size=32, depth=1, num_heads=4)


def teacher_check_phase(device, full: bool) -> dict:
    """One DiT forward at batch 2 with CFG doubling (B = 4, T = 1 + 154 +
    312 = 467 at full width), f32 with TF32 off: use_flash=True against
    use_flash=False, max abs error of eps against DIT_TOL. Then the same DiT
    and inputs in bf16: the mean error of eps with flash (the tensor-core
    kernel, one launch per self-attention) against the f32 einsum eps at
    most 1.02x the bf16 einsum path's."""
    from audiolcm_torch import obs
    from audiolcm_torch.models.dit import ConcatDiT2MLP

    latent = 312 if full else 16
    with torch.device(device):
        dit = ConcatDiT2MLP(**dit_kwargs(full)).eval()
    init_random_(dit, torch.Generator(device).manual_seed(3))
    g = torch.Generator(device).manual_seed(5)
    x = torch.randn(2, latent, dit.in_channels, generator=g, device=device)
    ctx = torch.randn(2, 154, dit.context_dim, generator=g, device=device)
    uc = torch.randn(1, 154, dit.context_dim, generator=g, device=device)
    x2, c2 = torch.cat([x, x]), torch.cat([uc.expand_as(ctx), ctx])
    t2 = torch.tensor([999, 500, 999, 500], dtype=torch.int32, device=device)
    with torch.inference_mode():
        eps = {}
        for flash in (False, True):
            set_flash(dit, flash)
            eps[flash] = dit(x2, t2, c2, None)
    sync(device)
    err = (eps[True] - eps[False]).abs().max().item()
    row = {"batch": 2, "dit_batch": 4, "seq": 1 + 154 + latent, "dtype": "float32",
           "flash_vs_einsum_eps_max_abs": err, "tol": DIT_TOL,
           "eps_abs_max": eps[False].abs().max().item()}
    emit({"phase": "teacher_f32_check", **row})
    if not err <= DIT_TOL:
        raise AssertionError(f"DiT eps with flash attention vs einsum: {row}")
    dit = dit.to(torch.bfloat16)
    with torch.inference_mode():
        bf16_err, n_tc = {}, 0
        for flash in (False, True):
            set_flash(dit, flash)
            n0 = obs.counters().get("flash_attention.tc", 0)
            out = dit(x2.bfloat16(), t2, c2.bfloat16(), None).float()
            sync(device)
            n_tc += obs.counters().get("flash_attention.tc", 0) - n0
            bf16_err[flash] = (out - eps[False]).abs().mean().item()
    n_attn = 2 * len(dit.blocks)
    row_b = {"batch": 2, "dit_batch": 4, "seq": 1 + 154 + latent, "dtype": "bfloat16",
             "flash_eps_mean_err": bf16_err[True], "einsum_eps_mean_err": bf16_err[False],
             "ratio": bf16_err[True] / bf16_err[False], "bar": 1.02,
             "tc_launches": n_tc}
    emit({"phase": "teacher_bf16_check", **row_b})
    if not (bf16_err[True] <= 1.02 * bf16_err[False]
            and n_tc == (n_attn if device.type == "cuda" else 0)):
        raise AssertionError(f"bf16 DiT eps with flash attention vs the f32 golden: {row_b}")
    return {"f32": row, "bf16": row_b}


def teacher_generate(pipe, ids, uc_ids, latent: int, gen, steps: int = 100,
                     use_plms: bool = False):
    """What the CLI's --teacher path runs for one batch: prompt and uncond
    contexts from token ids, then DDIM (or PLMS) with guidance 5."""
    with torch.inference_mode():
        ctx = pipe.encode_text_ids(ids[0], ids[1])
        uc = pipe.encode_text_ids(uc_ids[0], uc_ids[1])
    return pipe.generate_teacher(ctx, uc, latent, num_steps=steps, guidance_scale=GUIDANCE,
                                 use_plms=use_plms, generator=gen)


def teacher_phase(device, mods, full: bool, card: dict) -> dict:
    """The teacher path at full width: batch 8 (DiT batch 16 under CFG),
    10 s clips, bf16, DDIM 100 steps with flash attention, the serving
    vocoder (fused stages at C <= 48)."""
    from audiolcm_torch.diffusion.ddim import make_ddim_timesteps
    from audiolcm_torch.pipeline import AudioLCMPipeline

    batch, latent, tok = (8, 312, 77) if full else (2, 16, 77)
    ids, uc_ids = token_ids(mods, batch, tok, seed=0), token_ids(mods, 1, tok, seed=10)
    set_flash(mods.dit, True)
    pipe = AudioLCMPipeline(mods, compute_dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device).manual_seed(4)
    run = lambda steps=100, plms=False: teacher_generate(pipe, ids, uc_ids, latent, gen, steps,
                                                         plms)
    run()  # warm-up
    sync(device)
    reset_counts()
    wav, mel = run()
    sync(device)
    launches = read_counts()
    on_card = device.type == "cuda"
    n_attn = 2 * len(mods.dit.blocks)  # self-attentions per DiT forward
    n_steps = len(make_ddim_timesteps(100))
    expect = (batch, latent * 2 * 256)
    row = {"batch": batch, "dit_batch": 2 * batch, "sampler": "ddim", "steps": n_steps,
           "guidance": GUIDANCE, "wav_shape": list(wav.shape), "mel_shape": list(mel.shape),
           "finite": bool(torch.isfinite(wav).all()), "wav_abs_max": wav.abs().max().item(),
           "wav_std": wav.std().item(), "launches": launches}
    n_flash = n_attn * n_steps if on_card else 0
    want = counts_with(amp_stage_mma=2 if on_card else 0, flash_attention_tc=n_flash,
                       alias_free_act=k5_launches(mods.vocoder, torch.bfloat16, on_card,
                                                  2 * latent),
                       wide_conv=k6_launches(mods.vocoder, torch.bfloat16, on_card, 2 * latent))
    if not (tuple(wav.shape) == expect and row["finite"] and row["wav_abs_max"] <= 1.0
            and launches == want):
        emit({"phase": "teacher", **row})
        raise AssertionError(f"teacher path check failed: {row}, launches expected {want}")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        iters = 2
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / iters
        row.update(ms_per_generate=ms, x_realtime=batch * expect[1] / 16000 / (ms / 1e3),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card["nvidia_smi"])
        row["breakdown_ms"] = teacher_breakdown(pipe, ids, uc_ids, latent, gen)
        row["profile"] = profile_run(run, ms, watch=("flash_attention", "amp_stage"))
    else:
        row.update(ms_per_generate="not measured", x_realtime="not measured")
    # PLMS, 25 steps: one more DiT forward at step 0
    reset_counts()
    t0 = time.perf_counter()
    wav, _ = run(25, True)
    sync(device)
    plms = {"steps": 25, "launches": read_counts(), "finite": bool(torch.isfinite(wav).all())}
    if on_card:
        plms["ms_one_generate"] = 1e3 * (time.perf_counter() - t0)
    row["plms"] = plms
    n_plms = n_attn * (len(make_ddim_timesteps(25)) + 1) if on_card else 0
    if not (plms["finite"] and plms["launches"]["flash_attention.tc"] == n_plms
            and plms["launches"]["flash_attention.f32"] == 0):
        emit({"phase": "teacher", **row})
        raise AssertionError(f"PLMS-25 check failed: {plms}, flash launches expected {n_plms}")
    set_flash(mods.dit, False)
    emit({"phase": "teacher", **row})
    return row


def flag_teacher_phase(device, mods, full: bool, card: dict) -> dict:
    """The teacher path with the Flag DiT in place of ConcatDiT2MLP
    (TxtFlagLargeDiT at Lumina-T2X's 2B widths: hidden 2304, 24 blocks, 32
    heads of 72, SwiGLU 6144, qk-norm, its serving route), the other
    modules shared: batch 8, 10 s, bf16, DDIM 100 steps, guidance 5. Two K3
    launches per block and step on the tensor-core kernel, the
    self-attention and the caption branch (312 queries over 154 keys), the
    latter counted again in `flash_attention.cross`: 4800 and 2400."""
    from audiolcm_torch.models.flag_dit import TxtFlagLargeDiT
    from audiolcm_torch.pipeline import AudioLCMPipeline

    batch, latent, tok = (8, 312, 77) if full else (2, 16, 77)
    kw = (dict(hidden_size=2304, depth=24, num_heads=32, qk_norm=True) if full
          else dict(context_dim=32, hidden_size=32, depth=1, num_heads=4, qk_norm=True))
    with torch.device(device):
        flag = TxtFlagLargeDiT(**kw, use_flash=True)
    init_random_(flag, torch.Generator(device).manual_seed(5))
    ids, uc_ids = token_ids(mods, batch, tok, seed=0), token_ids(mods, 1, tok, seed=10)
    pipe = AudioLCMPipeline(dataclasses.replace(mods, dit=flag), compute_dtype=torch.bfloat16,
                            device=device)
    gen = torch.Generator(device).manual_seed(4)
    run = lambda: teacher_generate(pipe, ids, uc_ids, latent, gen)
    run()  # warm-up
    sync(device)
    reset_counts()
    wav, mel = run()
    sync(device)
    launches = read_counts()
    on_card = device.type == "cuda"
    n_steps = 100
    expect = (batch, latent * 2 * 256)
    row = {"dit": "TxtFlagLargeDiT", **kw, "params": sum(p.numel() for p in flag.parameters()),
           "batch": batch, "dit_batch": 2 * batch, "sampler": "ddim", "steps": n_steps,
           "guidance": GUIDANCE, "wav_shape": list(wav.shape), "mel_shape": list(mel.shape),
           "finite": bool(torch.isfinite(wav).all()), "wav_abs_max": wav.abs().max().item(),
           "wav_std": wav.std().item(), "launches": launches}
    n_flash = 2 * len(flag.blocks) * n_steps if on_card else 0
    want = counts_with(amp_stage_mma=2 if on_card else 0, flash_attention_tc=n_flash,
                       flash_attention_cross=n_flash // 2,
                       alias_free_act=k5_launches(mods.vocoder, torch.bfloat16, on_card,
                                                  2 * latent),
                       wide_conv=k6_launches(mods.vocoder, torch.bfloat16, on_card, 2 * latent))
    if not (tuple(wav.shape) == expect and row["finite"] and row["wav_abs_max"] <= 1.0
            and launches == want):
        emit({"phase": "flag_teacher", **row})
        raise AssertionError(f"Flag teacher path check failed: {row}, launches expected {want}")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        row.update(ms_one_generate=ms, x_realtime=batch * expect[1] / 16000 / (ms / 1e3),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card["nvidia_smi"])
    else:
        row.update(ms_one_generate="not measured", x_realtime="not measured")
    emit({"phase": "flag_teacher", **row})
    return row


def teacher_breakdown(pipe, ids, uc_ids, latent: int, gen) -> dict:
    """CUDA-event ms of each layer of one batch-8 teacher generate; the
    DiT's 100 steps with flash attention and again with einsum attention."""
    out = {}
    with torch.inference_mode():
        towers = lambda: (pipe.encode_text_ids(*ids), pipe.encode_text_ids(*uc_ids))
        ctx, uc = towers()
        out["text_towers_prompt_and_uncond"] = event_ms(towers, 3)
        sample = lambda: pipe.sample_latent_teacher(ctx, uc, latent, 100, GUIDANCE, False, gen)
        out["dit_ddim_100_steps_flash"] = event_ms(sample, 1)
        set_flash(pipe.modules.dit, False)
        out["dit_ddim_100_steps_einsum"] = event_ms(sample, 1)
        set_flash(pipe.modules.dit, True)
        z = sample()
        out["vae_decode"] = event_ms(lambda: pipe.decode_latent(z), 3)
        mel = pipe.decode_latent(z)
        out["vocoder"] = event_ms(lambda: pipe.vocode(mel), 3)
    return out


def interior_phase(device, shapes, card: dict, rehearsal: bool) -> dict:
    """The stage-interior profiler's full table at each shape (batch 8,
    bf16), one JSON line per row, through the port's tool module; the
    launch counts of that run. The rehearsal runs every variant once on the
    CPU's plain versions and times nothing."""
    import math

    from audiolcm_torch.tools.profile_stage_interior import profile_shape

    def untimed(fn, iters):
        fn()
        return math.nan

    def report(row):
        row = {k: "not measured" if isinstance(v, float) and math.isnan(v) else v
               for k, v in row.items()}
        emit({"phase": "interior", **row, "card": card["nvidia_smi"]})

    iters = 5
    reset_counts()
    tables = [profile_shape(c, t, device, iters=iters, batch=PROFILE_BATCH, report=report,
                            timer=untimed if rehearsal else None) for c, t in shapes]
    sync(device)
    launches = read_counts()
    emit({"phase": "interior_launches", "launches": launches})
    per_row = 0 if rehearsal else (1 + iters) * len(shapes)  # warm-up + iters per row
    n_k1, n_k4 = 6 * per_row, 2 * per_row  # 6 stage rows, 2 act rows
    if launches != counts_with(amp_stage_mma=n_k1, act_chain=n_k4):
        raise AssertionError(f"profiler run: launches {launches}, expected K1 {n_k1}, K4 {n_k4}")
    return {"launches": launches, "tables": tables}


def vocoder_args(full: bool) -> dict:
    """The vocoder's args (config.json schema): the shipped 16 kHz BigVGAN
    (1536 -> 24 channels), or the rehearsal's narrow one."""
    from audiolcm_torch.models.bigvgan import BigVGANConfig

    cfg = BigVGANConfig() if full else BigVGANConfig(upsample_initial_channel=192)
    return {"num_mels": cfg.num_mels, "upsample_rates": list(cfg.upsample_rates),
            "upsample_kernel_sizes": list(cfg.upsample_kernel_sizes),
            "upsample_initial_channel": cfg.upsample_initial_channel,
            "resblock_kernel_sizes": list(cfg.resblock_kernel_sizes),
            "resblock_dilation_sizes": [list(d) for d in cfg.resblock_dilation_sizes],
            "activation": cfg.activation, "snake_logscale": cfg.snake_logscale,
            "resblock": cfg.resblock, "sampling_rate": 16000, "n_fft": 1024, "win_size": 1024,
            "hop_size": 256, "fmin": 0, "fmax": 8000}


def mel_check(device, wav) -> dict:
    """melprep.wav_to_mel (the log-mel the prep and the vocoder CLI's wav
    mode compute on the card by default) on the card against the CPU, f32
    with TF32 off: max abs error of the log-mel <= MEL_TOL."""
    import numpy as np

    from audiolcm_torch.data.melprep import wav_to_mel

    mel = wav_to_mel(wav, device=device)
    ref = wav_to_mel(wav, device="cpu")
    row = {"samples": len(wav), "mel_shape": list(mel.shape),
           "log_mel_max_abs_err": float(np.abs(mel - ref).max()), "tol": MEL_TOL}
    emit({"phase": "vocode_mel_check", **row})
    if not (mel.shape == ref.shape and row["log_mel_max_abs_err"] <= MEL_TOL):
        raise AssertionError(f"log-mel on {device} vs the CPU: {row}")
    return row


def vocode_phase(device, full: bool, card: dict, tmp: str) -> dict:
    """`python -m audiolcm_torch.cli.vocoder_infer --input_mels_dir` on one
    10 s (624-frame) mel with a random-weight generator file and its
    config.json: the whole command's host-clock ms (checkpoint load and wav
    write included; the second of two runs), and the generator's own
    CUDA-event ms on that mel. f32, no fused stage (the CLI's defaults).
    Before it, mel_check on a 10 s tone in noise; after it, one run of
    the CLI's wav mode (--input_wavs_dir) on that wav."""
    import json
    import os

    import numpy as np
    from scipy.io import wavfile

    from audiolcm_torch import config as cfg_mod
    from audiolcm_torch.cli import vocoder_infer

    frames = 624 if full else 16
    n_wav = 16000 * (10 if full else 1)
    rng = np.random.default_rng(13)
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(n_wav) / 16000)
    wav_in = (tone + 0.1 * rng.standard_normal(n_wav)).astype(np.float32)
    mel_row = mel_check(device, wav_in)
    args = vocoder_args(full)
    voc = cfg_mod.build_vocoder_from_args(args)
    init_random_(voc, torch.Generator().manual_seed(6))
    ckpt = os.path.join(tmp, "g_00000000.pt")
    torch.save({"generator": voc.state_dict()}, ckpt)
    with open(os.path.join(tmp, "config.json"), "w") as f:
        json.dump(args, f)
    mels, out = os.path.join(tmp, "mels"), os.path.join(tmp, "out")
    os.makedirs(mels)
    mel = np.random.default_rng(7).standard_normal((80, frames)).astype(np.float32) - 4.0
    np.save(os.path.join(mels, "clip.npy"), mel)
    argv = ["--input_mels_dir", mels, "--output_dir", out, "--checkpoint_file", ckpt,
            "--device", str(device)]
    vocoder_infer.main(argv)  # warm-up
    sync(device)
    t0 = time.perf_counter()
    vocoder_infer.main(argv)
    sync(device)
    cli_ms = 1e3 * (time.perf_counter() - t0)
    sr, wav = wavfile.read(os.path.join(out, "clip_generated_e2e.wav"))
    row = {"batch": 1, "frames": frames, "channels": args["upsample_initial_channel"],
           "sample_rate": sr, "wav_len": len(wav), "wav_dtype": str(wav.dtype),
           "wav_abs_max": int(np.abs(wav.astype(np.int32)).max())}
    if not (sr == 16000 and wav.dtype == np.int16 and len(wav) == 256 * frames
            and row["wav_abs_max"] > 0):
        emit({"phase": "vocode", **row})
        raise AssertionError(f"vocoder_infer output check failed: {row}")
    if device.type == "cuda":
        gen, _ = vocoder_infer.load_generator(ckpt, device)
        x = torch.from_numpy(mel.T.copy())[None].to(device)
        with torch.inference_mode():
            voc_ms = event_ms(lambda: gen(x), iters=3)
        row.update(cli_ms=cli_ms, cli_x_realtime=frames * 256 / 16000 / (cli_ms / 1e3),
                   vocoder_ms=voc_ms, x_realtime=frames * 256 / 16000 / (voc_ms / 1e3),
                   card=card["nvidia_smi"])
    else:
        row.update(cli_ms="not measured", vocoder_ms="not measured", x_realtime="not measured")
    # wav mode: the CLI's own log-mel on --device, then the vocoder
    wavs, out_w = os.path.join(tmp, "wavs"), os.path.join(tmp, "out_wavs")
    os.makedirs(wavs)
    wavfile.write(os.path.join(wavs, "tone.wav"), 16000, (wav_in * 32767).astype(np.int16))
    vocoder_infer.main(["--input_wavs_dir", wavs, "--output_dir", out_w, "--checkpoint_file",
                        ckpt, "--device", str(device)])
    sr_w, wav_w = wavfile.read(os.path.join(out_w, "tone_generated.wav"))
    want = 256 * (1 + (n_wav + 2 * 384 - 1024) // 256)  # hop x frames of the padded wav
    row["wav_mode"] = {"in_samples": n_wav, "out_samples": len(wav_w), "sample_rate": sr_w,
                       "wav_abs_max": int(np.abs(wav_w.astype(np.int32)).max())}
    row["mel_check"] = mel_row
    emit({"phase": "vocode", **row})
    if not (sr_w == 16000 and wav_w.dtype == np.int16 and len(wav_w) == want
            and row["wav_mode"]["wav_abs_max"] > 0):
        raise AssertionError(f"vocoder_infer wav mode output check failed: {row['wav_mode']}")
    return row


def roundtrip_phase(device, full: bool, card: dict) -> dict:
    """The VAE round trip of cli/reconstruct_audio.py. Check: a full-width
    VAE (configs/autoencoder1d.yaml's ddconfig, random weights) encode_moments
    on one 10 s mel in f32 with TF32 off on the card against the same
    module on the CPU, max abs error <= MOMENTS_REL_TOL x max|moments|. Run:
    roundtrip() (encode, posterior sample, decode, vocode with the CLI's
    f32 unfused vocoder) at batch 8, 10 s."""
    import copy

    from audiolcm_torch import config as cfg_mod
    from audiolcm_torch.cli.reconstruct_audio import roundtrip
    from audiolcm_torch.models.vae1d import AutoencoderKL1D, VAEConfig

    frames = 624 if full else 16
    cfg = VAEConfig() if full else VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    vae_cpu = AutoencoderKL1D(cfg).eval()
    init_random_(vae_cpu, torch.Generator().manual_seed(8))
    vae = copy.deepcopy(vae_cpu).to(device)
    mel = torch.randn(1, frames, 80, generator=torch.Generator().manual_seed(9))
    with torch.inference_mode():
        ref = vae_cpu.encode_moments(mel)
        err = (vae.encode_moments(mel.to(device)).cpu() - ref).abs().max().item()
    scale = ref.abs().max().item()
    row = {"check": {"batch": 1, "frames": frames, "ch": cfg.ch, "dtype": "float32",
                     "moments_max_abs_err": err, "moments_abs_max": scale,
                     "tol": MOMENTS_REL_TOL * scale}}
    if not err <= MOMENTS_REL_TOL * scale:
        emit({"phase": "roundtrip", **row})
        raise AssertionError(f"VAE encode_moments on the card vs the CPU: {row['check']}")
    voc = cfg_mod.build_vocoder_from_args(vocoder_args(full)).to(device).eval()
    init_random_(voc, torch.Generator(device).manual_seed(10))
    batch = 8 if full else 2
    mels = torch.randn(batch, frames, 80, generator=torch.Generator(device).manual_seed(11),
                       device=device) - 4.0
    gen = torch.Generator(device).manual_seed(12)
    run = lambda: roundtrip(vae, voc, mels, gen)
    recon, wav = run()  # warm-up
    sync(device)
    ok = (tuple(recon.shape) == (batch, frames, 80) and tuple(wav.shape) == (batch, 256 * frames)
          and bool(torch.isfinite(wav).all()) and bool(torch.isfinite(recon).all()))
    row["run"] = {"batch": batch, "frames": frames, "recon_shape": list(recon.shape),
                  "wav_shape": list(wav.shape), "finite": ok,
                  "mse": ((recon - mels) ** 2).mean().item()}
    if not ok:
        emit({"phase": "roundtrip", **row})
        raise AssertionError(f"roundtrip output check failed: {row['run']}")
    if device.type == "cuda":
        iters = 2
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / iters
        row["run"].update(ms=ms, x_realtime=batch * frames * 256 / 16000 / (ms / 1e3),
                          card=card["nvidia_smi"])
    else:
        row["run"].update(ms="not measured", x_realtime="not measured")
    emit({"phase": "roundtrip", **row})
    return row


def median_ms(run, iters: int = 5) -> float:
    """Median host-clock ms of `iters` calls of run(), each ended by a
    synchronize (after one warm-up call)."""
    run()
    sync(torch.device("cuda"))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def prewarm_phase(device, mods, full: bool, card: dict) -> dict:
    """api.prewarm_buckets on the full-width serving pipeline (bf16, fast
    snake, fused stages at C <= 48): CUDA graphs of the whole generate at
    batch 8 for mel buckets 312, 624 and 1248 and at batch 1 for 624, all
    in one memory pool; per bucket the capture seconds and the pool's bytes
    after it. At (8, 312): the replayed waveform against the eager one from
    the same generator seed (max abs <= REPLAY_TOL), the median ms of 5
    replays and of 5 eager generates, each one's device busy ms and idle
    share (torch.profiler), and K1's launches per replay counted in the
    profiler's device trace (the Python counters count at capture). On the
    CPU, prewarm_buckets must refuse."""
    from audiolcm_torch.api import prewarm_buckets
    from audiolcm_torch.pipeline import AudioLCMPipeline

    pipe = AudioLCMPipeline(mods, compute_dtype=torch.bfloat16, device=device)
    if device.type != "cuda":
        try:
            prewarm_buckets(pipe, batch_sizes=(1,), mel_buckets=(32,))
        except ValueError as e:
            row = {"refused_on_cpu": str(e)}
            emit({"phase": "prewarm", **row})
            return row
        raise AssertionError("prewarm_buckets ran on a CPU pipeline")
    tok, latent = 77, 312
    reset_counts()
    hows = prewarm_buckets(pipe, batch_sizes=(8,), mel_buckets=(312, 624, 1248))
    hows.update(prewarm_buckets(pipe, batch_sizes=(1,), mel_buckets=(624,)))
    capture_launches = read_counts()
    buckets, prev = [], 0
    for g in pipe._graphs.values():  # in capture order
        b, lat = g.shape[0], g.latent_len
        buckets.append({"batch": b, "latent": lat, "mel": 2 * lat, "how": hows[(b, lat)],
                        "capture_s": g.capture_s, "pool_bytes_after": g.pool_bytes,
                        "pool_bytes_added": None if g.pool_bytes is None
                        else g.pool_bytes - prev})
        prev = g.pool_bytes or 0
    ids = token_ids(mods, 8, tok, seed=0)
    eager = AudioLCMPipeline(mods, compute_dtype=torch.bfloat16, device=device)
    gen = lambda: torch.Generator(device).manual_seed(21)
    with torch.inference_mode():
        wav_r, _ = pipe.generate(ids[0], ids[1], latent, generator=gen())
        wav_e, _ = eager.generate(ids[0], ids[1], latent, generator=gen())
    sync(device)
    diff = (wav_r - wav_e).abs().max().item()
    replay = lambda: pipe.generate(ids[0], ids[1], latent, generator=gen())
    run_eager = lambda: eager.generate(ids[0], ids[1], latent, generator=gen())
    reset_counts()
    replay()
    sync(device)
    replay_counts = read_counts()
    row = {"buckets": buckets, "capture_launches": capture_launches,
           "counts_per_replay": replay_counts, "replay_vs_eager_max_abs": diff,
           "tol": REPLAY_TOL, "wav_shape": list(wav_r.shape)}
    row["replay_ms"] = median_ms(replay)
    row["eager_ms"] = median_ms(run_eager)
    row["replay_profile"] = profile_run(replay, row["replay_ms"], watch=("amp_stage",))
    row["eager_profile"] = profile_run(run_eager, row["eager_ms"], watch=("amp_stage",))
    row["k1_launches_per_replay"] = sum(k["calls"] for k in row["replay_profile"]["watched"]
                                        if "amp_stage_mma_kernel" in k["name"])
    b1 = token_ids(mods, 1, tok, seed=3)
    row["b1_replay_ms"] = median_ms(lambda: pipe.generate(b1[0], b1[1], latent,
                                                          generator=gen()))
    row["card"] = card["nvidia_smi"]
    emit({"phase": "prewarm", **row})
    if not (all(h == "captured" for h in hows.values()) and len(hows) == 4 and diff <= REPLAY_TOL
            and row["k1_launches_per_replay"] == 2
            and replay_counts == counts_with(
                amp_stage_mma=2,
                alias_free_act=k5_launches(mods.vocoder, torch.bfloat16, True, 2 * latent),
                wide_conv=k6_launches(mods.vocoder, torch.bfloat16, True, 2 * latent))
            and bool(torch.isfinite(wav_r).all())):
        raise AssertionError(f"prewarm: {row}")
    pipe._graphs.clear()
    return row


def dit_forward_flop(dit, batch: int, seq: int) -> float:
    """FLOP of one DiT forward over `seq` tokens: per token and block, the
    conv-GEGLU FF (two kernel-9 convs d -> 2*4d, 4d -> d: 216 d^2), two
    self-attentions' projections (16 d^2), the 1x1 in/out (4 d^2) and
    their QK^T and PV (8 seq d); the embedders and head are < 1 %."""
    d = dit.blocks[0].proj_in.weight.shape[0]
    return batch * seq * len(dit.blocks) * (236 * d * d + 8 * seq * d)


def train_contexts(mods, device, batch: int, seed: int):
    """Prompt and uncond contexts from the towers in f32 on synthetic ids."""
    from audiolcm_torch.pipeline import AudioLCMPipeline

    pipe = AudioLCMPipeline(mods, compute_dtype=torch.float32, device=device)
    ids, uc_ids = token_ids(mods, batch, 77, seed=seed), token_ids(mods, 1, 77, seed=seed + 9)
    with torch.inference_mode():
        ctx, uc = pipe.encode_text_ids(*ids), pipe.encode_text_ids(*uc_ids)
    return ctx.clone(), uc.clone()


def updates_agree(after_a, after_b, before) -> dict:
    """Two updates of one parameter set (a - before, b - before; before in
    f64) held to each other: the L2 norm of their difference over all
    parameters relative to b's, the largest element difference, and that
    over b's largest element."""
    sq_diff = sq_b = 0.0
    max_diff = max_b = 0.0
    for k, v0 in before.items():
        da = (after_a[k].cpu() - v0).double()
        db = (after_b[k].cpu() - v0).double()
        sq_diff += (da - db).square().sum().item()
        sq_b += db.square().sum().item()
        max_diff = max(max_diff, (da - db).abs().max().item())
        max_b = max(max_b, db.abs().max().item())
    return {"update_rel_l2_diff": (sq_diff / sq_b) ** 0.5 if sq_b else float("inf"),
            "update_max_abs_diff": max_diff,
            "update_max_diff_over_max_update": max_diff / max_b if max_b else float("inf")}


def train_phase(device, mods, full: bool, card: dict, kind: str) -> dict:
    """One trainer at full width, f32 with TF32 off: the DiT of the shipped
    configs, random weights from a seed, synthetic latents, contexts from
    the towers. `kind` "distill": LCM distillation (teacher, student, EMA
    target) at batch 8; "teacher_train": the teacher step at batch 4.

    1. One step with injected draws and SGD lr 1 on the card and on the
       CPU: in f32, the loss at TRAIN_RTOL; in f64, the loss and the
       student's update (`updates_agree`: in L2 over all parameters and
       its largest element over the largest update) at TRAIN_RTOL. The
       update is held in f64 because in f32 the distillation update is
       not reproducible to 1e-4 by either device: elements of the
       consistency gap within a few c of 0 have a gradient d / sqrt(d^2 +
       c^2) that the f32 rounding of the O(10) predictions moves by
       percents; both f32 updates' distances from the f64 one are printed.
       For distillation the target is first moved off the student (0.02
       N(0, 1) per weight) so that the gap lies far above c.
    2. Trainer.fit for 5 steps with the shipped optimiser chain (clip,
       AdamW, warm-up schedule), metrics in JSONL, a checkpoint after step
       5 in a temp dir, restored into a fresh state: every tensor equal.
    3. ms per step (CUDA events, median of 5 after the fit), peak
       allocated memory over those steps, and the step's f32 bound: its
       DiT FLOP (`dit_forward_flop`) over the CUDA cores' f32 peak (TF32
       is off)."""
    import copy
    import json
    import os

    from audiolcm_torch.diffusion.schedule import NoiseSchedule
    from audiolcm_torch.models.dit import ConcatDiT2MLP
    from audiolcm_torch.train import lcm_distill as L
    from audiolcm_torch.train import teacher as TT
    from audiolcm_torch.train.checkpoints import CheckpointManager
    from audiolcm_torch.train.loop import Trainer

    distill = kind == "distill"
    batch = (8 if distill else 4) if full else 2
    latent = 312 if full else 16
    ctx, uc = train_contexts(mods, device, batch, seed=40)
    with torch.device(device):
        dit = ConcatDiT2MLP(**dit_kwargs(full))  # use_flash=False, as the trainers build it
    init_random_(dit, torch.Generator(device).manual_seed(41))
    g = torch.Generator(device).manual_seed(42)
    z = torch.randn(batch, latent, dit.in_channels, generator=g, device=device)
    schedule = NoiseSchedule.linear()
    sgd = lambda p: torch.optim.SGD(p, lr=1.0)
    if distill:
        cfg = L.LCMDistillConfig()
        draws = {"index": torch.randint(0, 50, (batch,), generator=g, device=device),
                 "noise": torch.randn(z.shape, generator=g, device=device),
                 "w": 4.0 + 8.0 * torch.rand((batch,), generator=g, device=device)}
        tg = torch.Generator(device).manual_seed(43)
        target_sd = {k: v + 0.02 * torch.randn(v.shape, generator=tg, device=device)
                     for k, v in dit.state_dict().items()}
    else:
        cfg = TT.TeacherConfig()
        draws = {"t": torch.randint(0, 1000, (batch,), generator=g, device=device),
                 "noise": torch.randn(z.shape, generator=g, device=device)}

    cpu = torch.device("cpu")

    def one_step(dev, dtype=torch.float32):
        model = copy.deepcopy(dit).to(dev, dtype)
        args = [t.to(dev, dtype) for t in (z, ctx)]
        kw = {k: v.to(dev, dtype if v.is_floating_point() else v.dtype)
              for k, v in draws.items()}
        if distill:
            teacher = copy.deepcopy(model).requires_grad_(False)
            state = L.init_train_state(model, cfg, optimizer=sgd)
            state.target.load_state_dict({k: v.to(dev, dtype) for k, v in target_sd.items()})
            state, m = L.make_lcm_distill_step(schedule, cfg)(
                state, teacher, L.Batch(*args), uc.to(dev, dtype), **kw)
            params = state.student
        else:
            state = TT.init_teacher_state(model, cfg, optimizer=sgd)
            state, m = TT.make_teacher_step(schedule, cfg)(state, *args, **kw)
            params = state.model
        return float(m["train/loss"]), {k: v.detach() for k, v in params.state_dict().items()}

    before = {k: v.detach().cpu().double() for k, v in dit.state_dict().items()}
    f64 = torch.float64
    (loss_dev, after_dev), (loss_cpu, after_cpu) = one_step(device), one_step(cpu)
    (loss_dev64, after_dev64), (loss_64, after_64) = one_step(device, f64), one_step(cpu, f64)
    same = updates_agree(after_dev64, after_64, before)
    row = {"batch": batch, "latent": latent, "dtype": "float32", "tf32": False,
           "loss_card": loss_dev, "loss_cpu": loss_cpu,
           "loss_rel_diff": abs(loss_dev - loss_cpu) / abs(loss_cpu),
           "loss_f64_rel_diff": abs(loss_dev64 - loss_64) / abs(loss_64), "rtol": TRAIN_RTOL,
           "update_f64_card_vs_cpu": same,
           "update_f32_card_vs_f64": updates_agree(after_dev, after_64, before),
           "update_f32_cpu_vs_f64": updates_agree(after_cpu, after_64, before)}
    if not (row["loss_rel_diff"] <= TRAIN_RTOL and row["loss_f64_rel_diff"] <= TRAIN_RTOL
            and same["update_rel_l2_diff"] <= TRAIN_RTOL
            and same["update_max_diff_over_max_update"] <= TRAIN_RTOL):
        emit({"phase": kind, **row})
        raise AssertionError(f"{kind}: card vs CPU step: {row}")

    # Trainer.fit with the shipped optimiser chain, checkpoint and restore
    def fresh_state():
        model = copy.deepcopy(dit)
        return (L.init_train_state(model, cfg) if distill else TT.init_teacher_state(model, cfg))

    teacher = copy.deepcopy(dit).requires_grad_(False)
    if distill:
        step = L.make_lcm_distill_step(schedule, cfg)
        step_fn = lambda st, b, gen: step(st, teacher, L.Batch(*b), uc, gen)
    else:
        step = TT.make_teacher_step(schedule, cfg)
        step_fn = lambda st, b, gen: step(st, b[0], b[1], gen)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        trainer = Trainer(step_fn, fresh_state(), tmp, checkpoints=mgr, log_every=1,
                          checkpoint_every_steps=5, tensorboard=False)
        gen = torch.Generator(device).manual_seed(44)
        trainer.fit(lambda epoch: [(z, ctx)] * 5, num_epochs=1, generator=gen)
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            losses = [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]
        restored = mgr.restore(template=fresh_state())
        saved = trainer.state.state_dict()
        exact = all(torch.equal(a, b) for a, b in zip(_tensors(saved), _tensors(
            restored.state_dict())))
        row.update(fit_steps=trainer.global_step, fit_losses=losses,
                   checkpoint_steps=mgr.all_steps(), restored_step=restored.step,
                   restored_bit_exact=exact)
    if not (len(losses) == 5 and all(map(math.isfinite, losses)) and exact
            and restored.step == 5):
        emit({"phase": kind, **row})
        raise AssertionError(f"{kind}: Trainer.fit / checkpoint: {row}")
    if device.type == "cuda":
        state = trainer.state
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = step_fn(state, (z, ctx), gen)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        # forward-equivalents per step: distillation 3 forwards without grad
        # and the student's forward + backward (3); the teacher step 3
        flop = (6 if distill else 3) * dit_forward_flop(dit, batch, 1 + ctx.shape[1] + latent)
        row.update(ms_per_step=sorted(times)[2], ms_steps=times,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   tflop_per_step=flop / 1e12, f32_bound_ms=1e3 * flop / PEAK_F32,
                   card=card["nvidia_smi"])
    emit({"phase": kind, **row})
    return row


def training_counts_zero(kind: str) -> dict:
    """The launch counts since reset_counts(): a trainer (and the eval
    phases: the scorers, and the acceptance generate at stage knob 0; every
    phase whose path holds no TPU-kernel counterpart) runs BigVGAN unfused
    and the DiT on einsum attention, so K1, K3 and K4 must not have
    launched; K5 and K6 must have launched as often as its vocoder forwards
    owed (`_k5_due`, `_k6_due`: a discriminator step draws the generator's
    waveform without autograd)."""
    counts = read_counts()
    if counts != counts_with(alias_free_act=_k5_due, wide_conv=_k6_due):
        raise AssertionError(f"{kind}: launches {counts}, expected none but K5's "
                             f"{_k5_due} and K6's {_k6_due}")
    return counts


def step_flop(run) -> float:
    """FLOP of one call of run(): every matmul and convolution that reaches
    the dispatcher (forward, backward and R1's double backward), counted by
    torch.utils.flop_counter's formulas (its FlopCounterMode's module hooks
    do not allow autograd.grad on a leaf, which R1 takes)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.total += formula(*args, **(kwargs or {}), out_val=out)
            return out

    with Count() as counter:
        run()
    return float(counter.total)


def timed_steps(step, n: int) -> list:
    """CUDA-event ms of n calls of step()."""
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def write_manifest(root: str, n: int, mel_num: int, frames: int, seed: int) -> None:
    """n random (mel_num, frames) .npy mels and a data.tsv over them (the
    first 100 rows are the val split)."""
    import csv
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "data.tsv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["name", "dataset", "ori_cap", "caption", "mel_path",
                                          "audio_path", "duration"], delimiter="\t")
        w.writeheader()
        for i in range(n):
            path = os.path.join(root, f"m{i}.npy")
            np.save(path, (rng.standard_normal((mel_num, frames)) - 2.0).astype(np.float32))
            w.writerow({"name": f"c{i}", "dataset": "syn", "ori_cap": f"a sound {i}",
                        "caption": f"<sound {i}& all>", "mel_path": path, "audio_path": "",
                        "duration": frames / 62.5})


def read_run(logroot: str) -> tuple:
    """(metrics.jsonl records, checkpoint steps) of the one run under logroot."""
    import os

    (run,) = os.listdir(logroot)
    with open(os.path.join(logroot, run, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    return lines, sorted(int(s) for s in os.listdir(os.path.join(logroot, run, "checkpoints")))


def vae_train_config(full: bool, root: str) -> dict:
    """configs/autoencoder1d.yaml (the rehearsal: ch 32, ch_mult (1, 2), mel
    16, 32 frames, discriminator ndf 8 with 2 strided layers) with
    disc_start 0 and the data at `root`."""
    from audiolcm_torch.config import load_yaml

    cfg = load_yaml("configs/autoencoder1d.yaml")
    p = cfg["model"]["params"]
    p["lossconfig"]["params"]["disc_start"] = 0
    if not full:
        p.update(embed_dim=4)
        p["ddconfig"].update(in_channels=16, out_ch=16, z_channels=4, ch=32, ch_mult=[1, 2],
                             num_res_blocks=1, attn_layers=[])
        p["lossconfig"]["params"].update(disc_hidden_size=8, disc_num_layers=2)
    cfg["data"]["params"].update(spec_dir_path=root, mel_num=80 if full else 16,
                                 spec_len=624 if full else 32)
    return cfg


def train_vae_phase(device, full: bool, card: dict) -> dict:
    """The VAE GAN at configs/autoencoder1d.yaml's widths (VAE ch 384, embed
    20, mel 80 x 624 frames, NLayerDiscriminator2D ndf 64, 3 layers, one
    input channel), disc_start 0 so that the adversarial term, the adaptive
    weight and R1 are live; f32, TF32 off.

    1. One generator + discriminator step on the card and on the CPU at
       batch 2 from the same weights (`init_random_`) and posterior noise,
       SGD at VAE_SGD_LR (the L1 sum over 80 x 624 bins makes gradients of
       ~1e4-1e5; at lr 1 the updated VAE's reconstruction overflows f32 in
       the discriminator step): the seven losses at TRAIN_RTOL in f32 (the
       two logit means printed); in f64 the losses and the VAE's and
       discriminator's updates (`updates_agree`) at TRAIN_RTOL, the f32
       updates' distance from the f64 one printed (as the distillation row:
       the L1 sum's gradient takes the sign of each reconstruction error,
       so f32 rounding near 0 moves it by its full size).
    2. ms per step at the config's batch 4 with the shipped Adam pair (CUDA
       events, median of 5), peak GB, the f32 bound (`step_flop`'s FLOP of
       one step over the CUDA cores' f32 rate).
    3. `cli.train.main` for one epoch on 132 random mels (100 val, 32
       train: 8 steps at batch 4): metrics.jsonl with finite val losses
       and a checkpoint. K1 and K3 launch 0 times in all of it."""
    import copy
    import os

    from audiolcm_torch import config as cfg_mod
    from audiolcm_torch.cli import train as cli
    from audiolcm_torch.models.discriminators import NLayerDiscriminator2D
    from audiolcm_torch.train import vae_gan

    t0 = time.time()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = vae_train_config(full, os.path.join(tmp, "data"))
        dp, lp = cfg["data"]["params"], cfg["model"]["params"]["lossconfig"]["params"]
        mel_num, frames = dp["mel_num"], dp["spec_len"]
        torch.manual_seed(60)
        vae = cfg_mod.build_from_target(cfg["model"])
        disc = NLayerDiscriminator2D(1, lp.get("disc_hidden_size", 64),
                                     lp.get("disc_num_layers", 3))
        for i, m in enumerate((vae, disc)):  # O(1) activations and patch logits
            init_random_(m, torch.Generator().manual_seed(64 + i))
        gcfg = vae_gan.VAEGANConfig(disc_start=0)
        g = torch.Generator().manual_seed(61)
        mel = torch.randn(2, frames, mel_num, generator=g) - 2.0
        down = 2 ** len(vae.config.down_layers)
        noise = torch.randn(2, frames // down, vae.config.embed_dim, generator=g)

        def one_step(dev, dtype=torch.float32):
            st = vae_gan.init_vae_gan_state(copy.deepcopy(vae).to(dev, dtype),
                                            copy.deepcopy(disc).to(dev, dtype), gcfg,
                                            optimizer=lambda p: torch.optim.SGD(
                                                p, lr=VAE_SGD_LR))
            _, _, step = vae_gan.make_vae_gan_steps(gcfg)
            st, m = step(st, mel.to(dev, dtype), noise=noise.to(dev, dtype))
            params = {**{"vae." + k: v for k, v in st.vae.state_dict().items()},
                      **{"disc." + k: v for k, v in st.disc.state_dict().items()
                         if v.is_floating_point()}}
            return {k: float(v) for k, v in m.items()}, {k: v.detach() for k, v in params.items()}

        before = {**{"vae." + k: v.double() for k, v in vae.state_dict().items()},
                  **{"disc." + k: v.double() for k, v in disc.state_dict().items()
                     if v.is_floating_point()}}
        cpu = torch.device("cpu")
        (m_dev, a_dev), (m_cpu, a_cpu) = one_step(device), one_step(cpu)
        (m_dev64, a_dev64), (m_64, a_64) = (one_step(device, torch.float64),
                                            one_step(cpu, torch.float64))
        # the losses; the logit means are reported beside them
        rel = lambda a, b: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b
                               if "logits" not in k)
        same = updates_agree(a_dev64, a_64, before)
        row = {"batch_check": 2, "frames": frames, "mel": mel_num, "dtype": "float32",
               "tf32": False, "disc_start": 0, "losses_card": m_dev,
               "loss_rel_diff_max": rel(m_dev, m_cpu), "loss_f64_rel_diff_max": rel(m_dev64, m_64),
               "rtol": TRAIN_RTOL, "update_f64_card_vs_cpu": same,
               "update_f32_card_vs_f64": updates_agree(a_dev, a_64, before),
               "update_f32_cpu_vs_f64": updates_agree(a_cpu, a_64, before)}
        if not (row["loss_rel_diff_max"] <= TRAIN_RTOL
                and row["loss_f64_rel_diff_max"] <= TRAIN_RTOL
                and same["update_rel_l2_diff"] <= TRAIN_RTOL
                and same["update_max_diff_over_max_update"] <= TRAIN_RTOL
                and m_dev["train/g_loss"] != 0 and m_dev["train/r1_penalty"] > 0):
            emit({"phase": "train_vae", **row})
            raise AssertionError(f"train_vae: card vs CPU step: {row}")

        batch = dp["batch_size"]
        if device.type == "cuda":
            st = vae_gan.init_vae_gan_state(copy.deepcopy(vae).to(device),
                                            copy.deepcopy(disc).to(device), gcfg)
            _, _, step = vae_gan.make_vae_gan_steps(gcfg)
            mel_b = torch.randn(batch, frames, mel_num, device=device) - 2.0
            gen = torch.Generator(device).manual_seed(62)
            run = lambda: step(st, mel_b, gen)
            run()
            flop = step_flop(run)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = timed_steps(run, 5)
            row.update(batch=batch, ms_per_step=sorted(times)[2], ms_steps=times,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                       tflop_per_step=flop / 1e12, f32_bound_ms=1e3 * flop / PEAK_F32,
                       card=card["nvidia_smi"])
            del st
        write_manifest(dp["spec_dir_path"], 100 + 8 * batch, mel_num, frames, seed=63)
        path = os.path.join(tmp, "vae.yaml")
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        logroot = os.path.join(tmp, "logs")
        cli.main(["-b", path, "-t", "--max_epochs", "1", "-l", logroot, "--device", str(device)])
        lines, ckpts = read_run(logroot)
    val = [x for x in lines if "val/nll_loss" in x]
    row.update(cli_steps=8, cli_checkpoints=ckpts, cli_epoch_time_s=val[-1]["epoch_time_s"],
               cli_val_nll_loss=val[-1]["val/nll_loss"], cli_val_disc_loss=val[-1]["val/disc_loss"],
               launches=training_counts_zero("train_vae"), seconds=time.time() - t0)
    if not (ckpts == [8] and all(map(math.isfinite, (val[-1]["val/nll_loss"],
                                                     val[-1]["val/disc_loss"])))):
        emit({"phase": "train_vae", **row})
        raise AssertionError(f"train_vae: the CLI run: {row}")
    emit({"phase": "train_vae", **row})
    return row


class StubTokenizers:
    """Deterministic token ids in place of the HF tokenizers (no assets on
    the machine): 77 ids per caption, the same for every caption."""

    max_length = 77

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, ori, struct):
        ids = (torch.arange(self.max_length)[None, :].repeat(len(ori), 1) * 7) % 997
        return ids, ids


def diffusion_train_config(full: bool, name: str, root: str, other: str) -> dict:
    """configs/teacher.yaml or configs/audiolcm.yaml with the data at `root`
    (teacher: `other` as its second pool); the rehearsal shrinks the DiT,
    the VAE and the towers (bert_config / t5_config)."""
    from audiolcm_torch.config import load_yaml

    cfg = load_yaml(f"configs/{name}.yaml")
    p = cfg["model"]["params"]
    data = {"batch_size": cfg["data"]["params"]["batch_size"], "mel_num": 80 if full else 16}
    if name == "teacher":
        data.update(main_spec_dir_path=root, other_spec_dir_path=other)
    else:
        data.update(spec_dir_path=root)
    cfg["data"] = {"params": data}
    if not full:
        p["unet_config"]["params"].update(context_dim=32, hidden_size=32, depth=1, num_heads=4)
        p["first_stage_config"]["params"]["ddconfig"].update(
            in_channels=16, out_ch=16, ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_layers=[])
        p["cond_stage_config"]["params"].update(
            d_proj=32, bert_config={"vocab_size": 1000, "hidden_size": 16, "num_layers": 1,
                                    "num_heads": 2, "intermediate_size": 32,
                                    "max_position_embeddings": 80},
            t5_config={"vocab_size": 1000, "d_model": 32, "d_kv": 8, "d_ff": 48,
                       "num_layers": 1, "num_heads": 2})
    return cfg


def train_cli_phase(device, full: bool, card: dict) -> list:
    """`cli.train.main` at the full widths of configs/teacher.yaml (two
    pools) and configs/audiolcm.yaml: the shipped DiT, VAE, BERT-base and
    T5-large towers fresh from `_fill_missing_parts` (no checkpoint exists
    here), stub tokenizers, f32 with TF32 off, the YAMLs' batch sizes
    (teacher 4, LCM 8), 10 s mels (624 frames); 2 epochs of 2 train batches
    (teacher: 2 main + 2 other batches) on a synthetic manifest. Per run:
    ms per step (host clock over the second epoch's steps, tokenization
    and the frozen encoders included), peak GB (the Trainer's), the
    metrics.jsonl with a finite val loss, the checkpoints, 0
    K1 / K3 launches."""
    import os

    import yaml

    from audiolcm_torch import api
    from audiolcm_torch.cli import train as cli

    rows = []
    frames = 624 if full else 32
    saved = api.Tokenizers
    api.Tokenizers = StubTokenizers
    try:
        for name, val_key in (("teacher", "val/loss_simple"), ("audiolcm", "val/loss")):
            t0 = time.time()
            reset_counts()
            with tempfile.TemporaryDirectory() as tmp:
                root, other = os.path.join(tmp, "main"), os.path.join(tmp, "other")
                cfg = diffusion_train_config(full, name, root, other)
                batch = cfg["data"]["params"]["batch_size"]
                mel_num = cfg["data"]["params"]["mel_num"]
                write_manifest(root, 100 + 2 * batch, mel_num, frames, seed=70)
                if name == "teacher":
                    write_manifest(other, 2 * batch, mel_num, frames, seed=71)
                path = os.path.join(tmp, f"{name}.yaml")
                with open(path, "w") as f:
                    yaml.safe_dump(cfg, f)
                logroot = os.path.join(tmp, "logs")
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                cli.main(["-b", path, "-t", "--max_epochs", "2", "-l", logroot,
                          "--device", str(device)])
                lines, ckpts = read_run(logroot)
            epochs = [x for x in lines if "epoch_time_s" in x]
            steps = epochs[-1]["step"] - epochs[0]["step"]
            row = {"config": f"configs/{name}.yaml", "batch": batch, "frames": frames,
                   "steps": epochs[-1]["step"], "checkpoints": ckpts,
                   "val_loss": epochs[-1].get(val_key),
                   "launches": training_counts_zero(f"train_cli {name}"),
                   "seconds": time.time() - t0}
            if device.type == "cuda":
                row.update(ms_per_step=1e3 * epochs[-1]["epoch_time_s"] / steps,
                           peak_mem_gb=epochs[-1]["peak_memory_mb"] * 2 ** 20 / 1e9,
                           card=card["nvidia_smi"])
            if not (ckpts and ckpts[-1] == epochs[-1]["step"] and row["val_loss"] is not None
                    and math.isfinite(row["val_loss"])):
                emit({"phase": "train_cli", **row})
                raise AssertionError(f"train_cli {name}: {row}")
            emit({"phase": "train_cli", **row})
            rows.append(row)
    finally:
        api.Tokenizers = saved
    return rows


def vocoder_train_config(full: bool) -> dict:
    """bigvgan_audioset16khz_80band.json: vocoder_args plus its training
    keys (segment 8192, batch 32, AdamW 1e-4 (0.8, 0.99), decay 0.999, MPD
    periods 2-11, the three MRD resolutions); the rehearsal's narrow
    generator, batch 2."""
    return {**vocoder_args(full), "segment_size": 8192, "batch_size": 32 if full else 2,
            "fmax_for_loss": None, "learning_rate": 1e-4, "adam_b1": 0.8, "adam_b2": 0.99,
            "lr_decay": 0.999, "mpd_reshapes": [2, 3, 5, 7, 11],
            "discriminator_channel_mult": 1,
            "resolutions": [[1024, 120, 600], [2048, 240, 1200], [512, 50, 240]]}


def train_vocoder_phase(device, full: bool, card: dict) -> dict:
    """The vocoder GAN CLI's build at the 16 kHz 80-band config (BigVGAN
    1536 -> 24 channels, unfused; MPD + MRD), f32 with TF32 off, on random
    16 kHz wavs written with scipy.

    1. One discriminator + generator step on the card and on the CPU at
       batch 2 from the same weights and segments, SGD lr 1: the five
       losses at TRAIN_RTOL.
    2. `fit` for 5 steps at the config's batch 32 (halved while the card
       runs out of memory, then `reduced` says so): ms per step (CUDA
       events around each step, median), peak GB, the f32 bound
       (`step_flop` over one step), metrics.jsonl and a checkpoint; 0
       K1 / K3 launches."""
    import copy
    import os

    import numpy as np
    from scipy.io import wavfile

    from audiolcm_torch.cli import train_vocoder as tv
    from audiolcm_torch.dsp.mel import MelConfig, MelSpectrogram
    from audiolcm_torch.train import vocoder_gan

    t0 = time.time()
    reset_counts()
    h = vocoder_train_config(full)
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(80)
        with open(os.path.join(tmp, "wavs.tsv"), "w") as f:
            f.write("name\taudio_path\n")
            for i in range(8):
                path = os.path.join(tmp, f"w{i}.wav")
                wavfile.write(path, 16000, (rng.standard_normal(32000) * 4000).astype(np.int16))
                f.write(f"w{i}\t{path}\n")
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(h, f)
        # 1. card vs CPU, batch 2
        torch.manual_seed(81)
        gen, mpd, mrd = tv.build_models(h, "cpu")
        mel_cfg = MelConfig(sample_rate=16000, n_fft=1024, win_size=1024, hop_size=256,
                            n_mels=80, fmin=0.0, fmax=8000.0)
        seg = next(tv.segment_loader(os.path.join(tmp, "wavs.tsv"), 2, 8192, 82,
                                     MelSpectrogram(mel_cfg, device="cpu")))
        vcfg = vocoder_gan.VocoderGANConfig()

        def one_step(dev):
            st = vocoder_gan.init_vocoder_gan_state(
                *(copy.deepcopy(m).to(dev) for m in (gen, mpd, mrd)), vcfg,
                optimizer=lambda p: torch.optim.SGD(p, lr=1.0))
            dstep, gstep = vocoder_gan.make_vocoder_gan_steps(
                vcfg, MelSpectrogram(dataclasses.replace(mel_cfg, fmax=8000.0), device=dev))
            mel = torch.as_tensor(seg["mel"], device=dev)
            wav = torch.as_tensor(seg["wav"], device=dev)
            st, dm = dstep(st, mel, wav)
            st, gm = gstep(st, mel, wav)
            return {k: float(v) for k, v in {**dm, **gm}.items()}

        m_dev, m_cpu = one_step(device), one_step(torch.device("cpu"))
        rel = max(abs(m_dev[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in m_cpu)
        row = {"batch_check": 2, "segment": 8192, "dtype": "float32", "tf32": False,
               "losses_card": m_dev, "loss_rel_diff_max": rel, "rtol": TRAIN_RTOL}
        if not rel <= TRAIN_RTOL:
            emit({"phase": "train_vocoder", **row})
            raise AssertionError(f"train_vocoder: card vs CPU step: {row}")
        del gen, mpd, mrd
        # 2. fit at the config's batch
        batch, reduced = h["batch_size"], None
        while True:
            h["batch_size"] = batch
            with open(os.path.join(tmp, "config.json"), "w") as f:
                json.dump(h, f)
            args = tv.parse_args(["--config", os.path.join(tmp, "config.json"), "--tsv_path",
                                  os.path.join(tmp, "wavs.tsv"), "--checkpoint_path",
                                  os.path.join(tmp, f"run{batch}"), "--device", str(device)])
            try:
                built = tv.build(args)
                trainer, times = built["trainer"], []
                inner = trainer.step_fn
                if device.type == "cuda":
                    def timed(state, b, g, inner=inner):
                        out = []
                        times.extend(timed_steps(lambda: out.append(inner(state, b, g)), 1))
                        return out[0]

                    trainer.step_fn = timed
                    torch.cuda.reset_peak_memory_stats()
                trainer.log_every = 1
                tv.fit(built, epochs=1, steps_per_epoch=5)
                break
            except torch.cuda.OutOfMemoryError:
                built = trainer = inner = None
                torch.cuda.empty_cache()
                batch, reduced = batch // 2, f"batch {h['batch_size']} did not fit; halved"
                if batch < 1:
                    raise
        with open(os.path.join(tmp, f"run{batch}", "metrics.jsonl")) as f:
            lines = [json.loads(x) for x in f]
        ckpts = os.listdir(os.path.join(tmp, f"run{batch}", "checkpoints"))
        gen_losses = [x["train/gen_loss"] for x in lines if "train/gen_loss" in x]
        row.update(batch=batch, reduced=reduced, fit_steps=built["state"].step,
                   gen_losses=gen_losses, checkpoints=sorted(ckpts))
        if device.type == "cuda":
            sample = next(built["loader_factory"](0, 1))
            flop = step_flop(lambda: inner(built["state"], sample, None))
            row.update(ms_per_step=sorted(times)[len(times) // 2], ms_steps=times,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                       tflop_per_step=flop / 1e12, f32_bound_ms=1e3 * flop / PEAK_F32,
                       card=card["nvidia_smi"])
    row.update(launches=training_counts_zero("train_vocoder"), seconds=time.time() - t0)
    if not (len(gen_losses) == 5 and all(map(math.isfinite, gen_losses)) and ckpts):
        emit({"phase": "train_vocoder", **row})
        raise AssertionError(f"train_vocoder: fit: {row}")
    emit({"phase": "train_vocoder", **row})
    return row


def ddp_phase(device, mods, full: bool, card: dict) -> dict:
    """The trainers inside a process group of one (NCCL on the card, gloo in
    the rehearsal) against the same steps outside it, from the same weights
    and draws, SGD, f32: one LCM distillation step with the student in
    DistributedDataParallel (batch 8), and one VAE GAN step at
    configs/autoencoder1d.yaml's widths (batch 2), whose discriminator
    BatchNorm then sums its statistics through the differentiable
    all-reduce, R1's double backward included. The same losses, and the
    updates within the f32 bar TRAIN_RTOL (`updates_agree`: DDP's bucketed
    backward may sum a gradient in another order; a second plain LCM step
    shows the card's own repeat spread). A run over several cards needs a
    machine with them."""
    import copy
    import os
    import socket

    import torch.distributed as dist

    from audiolcm_torch import config as cfg_mod
    from audiolcm_torch.diffusion.schedule import NoiseSchedule
    from audiolcm_torch.models.discriminators import NLayerDiscriminator2D
    from audiolcm_torch.models.dit import ConcatDiT2MLP
    from audiolcm_torch.parallel import mesh
    from audiolcm_torch.train import lcm_distill as L
    from audiolcm_torch.train import vae_gan

    t0 = time.time()
    reset_counts()
    batch, latent = (8, 312) if full else (2, 16)
    ctx, uc = train_contexts(mods, device, batch, seed=90)
    with torch.device(device):
        dit = ConcatDiT2MLP(**dit_kwargs(full))
    init_random_(dit, torch.Generator(device).manual_seed(91))
    g = torch.Generator(device).manual_seed(92)
    z = torch.randn(batch, latent, dit.in_channels, generator=g, device=device)
    cfg = L.LCMDistillConfig()
    vcfg = vae_train_config(full, "")
    lp = vcfg["model"]["params"]["lossconfig"]["params"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(94)
        vae = cfg_mod.build_from_target(vcfg["model"]).to(device)
        disc = NLayerDiscriminator2D(1, lp.get("disc_hidden_size", 64),
                                     lp.get("disc_num_layers", 3)).to(device)
    for i, m in enumerate((vae, disc)):
        init_random_(m, torch.Generator(device).manual_seed(95 + i))
    mel_num, frames = vcfg["data"]["params"]["mel_num"], vcfg["data"]["params"]["spec_len"]
    mel = torch.randn(2, frames, mel_num, generator=g, device=device) - 2.0
    gcfg = vae_gan.VAEGANConfig(disc_start=0)

    def lcm_step(wrap: bool):
        state = L.init_train_state(copy.deepcopy(dit), cfg,
                                   optimizer=lambda p: torch.optim.SGD(p, lr=1.0))
        if wrap:
            state.student = mesh.wrap_ddp(state.student)
        step = L.make_lcm_distill_step(NoiseSchedule.linear(), cfg)
        state, m = step(state, dit, L.Batch(z, ctx), uc, torch.Generator(device).manual_seed(93))
        return float(m["train/loss"]), mesh.unwrap(state.student).state_dict(), type(
            state.student).__name__

    def gan_step():
        st = vae_gan.init_vae_gan_state(copy.deepcopy(vae), copy.deepcopy(disc), gcfg,
                                        optimizer=lambda p: torch.optim.SGD(p, lr=VAE_SGD_LR))
        step = vae_gan.make_vae_gan_steps(gcfg)[2]
        st, m = step(st, mel, torch.Generator(device).manual_seed(96))
        return ({k: float(v) for k, v in m.items()},
                {**{"vae." + k: v for k, v in st.vae.state_dict().items()},
                 **{"disc." + k: v for k, v in st.disc.state_dict().items()
                    if v.is_floating_point()}})

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        assert mesh.init_distributed(device)
        backend = dist.get_backend()
        loss_ddp, sd_ddp, wrapped = lcm_step(True)
        gan_in, gan_sd_in = gan_step()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    loss, sd, plain = lcm_step(False)
    loss_again, sd_again, _ = lcm_step(False)
    gan_out, gan_sd_out = gan_step()
    before = {k: v.detach().cpu().double() for k, v in dit.state_dict().items()}
    gan_before = {**{"vae." + k: v.cpu().double() for k, v in vae.state_dict().items()},
                  **{"disc." + k: v.cpu().double() for k, v in disc.state_dict().items()
                     if v.is_floating_point()}}
    same = updates_agree(sd_ddp, sd, before)
    gan_same = updates_agree(gan_sd_in, gan_sd_out, gan_before)
    gan_rel = max(abs(gan_in[k] - gan_out[k]) / max(abs(gan_out[k]), 1e-12) for k in gan_out)
    row = {"backend": backend, "world_size": 1, "batch": batch, "latent": latent,
           "wrapped": wrapped, "unwrapped": plain, "loss_ddp": loss_ddp, "loss": loss,
           "update_ddp_vs_plain": same, "rtol": TRAIN_RTOL,
           "repeat_loss_equal": loss_again == loss,
           "update_plain_repeat": updates_agree(sd_again, sd, before),
           "vae_gan_loss_rel_diff_max": gan_rel, "vae_gan_update_group_vs_plain": gan_same,
           "launches": training_counts_zero("ddp"), "seconds": time.time() - t0,
           "card": card["nvidia_smi"]}
    emit({"phase": "ddp", **row})
    if not (wrapped == "DistributedDataParallel" and loss_ddp == loss
            and same["update_rel_l2_diff"] <= TRAIN_RTOL
            and same["update_max_diff_over_max_update"] <= TRAIN_RTOL
            and gan_rel <= TRAIN_RTOL and gan_same["update_rel_l2_diff"] <= TRAIN_RTOL
            and gan_same["update_max_diff_over_max_update"] <= TRAIN_RTOL):
        raise AssertionError(f"ddp: the step inside the group differs: {row}")
    return row


def fsdp_phase(device, mods, full: bool, card: dict) -> dict:
    """One LCM distillation step at full width (batch 8, f32, TF32 off) with
    the student and the EMA target sharded by `mesh.shard_module_fsdp`
    (FSDP2's fully_shard under JAX's fsdp_shardings rule) in a process group
    of one on NCCL (gloo in the rehearsal), against the plain step from the
    same weights and draws, SGD at lr 1: the same loss, the update within
    TRAIN_RTOL (`updates_agree`), and each step's ms (CUDA events, median
    of 5) and peak GB. 0 K1 / K3 / K4 launches. Several cards: a machine
    with them."""
    import copy
    import os
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from audiolcm_torch.diffusion.schedule import NoiseSchedule
    from audiolcm_torch.models.dit import ConcatDiT2MLP
    from audiolcm_torch.parallel import mesh
    from audiolcm_torch.train import lcm_distill as L

    t0 = time.time()
    on_card = device.type == "cuda"
    reset_counts()
    batch, latent = (8, 312) if full else (2, 16)
    ctx, uc = train_contexts(mods, device, batch, seed=130)
    with torch.device(device):
        dit = ConcatDiT2MLP(**dit_kwargs(full))
    init_random_(dit, torch.Generator(device).manual_seed(131))
    z = torch.randn(batch, latent, dit.in_channels, generator=torch.Generator(device).manual_seed(
        132), device=device)
    cfg = L.LCMDistillConfig()
    schedule = NoiseSchedule.linear()
    # a copy of the weights after the first step (the timed steps go on; in
    # a group of one a DTensor's full tensor is its own storage)
    whole = lambda sd: {k: (v.full_tensor() if isinstance(v, DTensor)  # noqa: E731
                            else v).detach().clone() for k, v in sd.items()}

    def lcm_run(shard: bool) -> dict:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        state = L.init_train_state(copy.deepcopy(dit), cfg,
                                   optimizer=lambda p: torch.optim.SGD(p, lr=1.0),
                                   wrap=mesh.shard_module_fsdp if shard else None)
        step = L.make_lcm_distill_step(schedule, cfg)
        gen = torch.Generator(device).manual_seed(133)
        state, m = step(state, dit, L.Batch(z, ctx), uc, gen)
        out = {"loss": float(m["train/loss"]), "student": whole(state.student.state_dict()),
               "sharded": sum(isinstance(p, DTensor) for p in state.student.parameters()),
               "params": sum(1 for _ in state.student.parameters())}
        if on_card:
            out["ms"] = sorted(timed_steps(lambda: step(state, dit, L.Batch(z, ctx), uc, gen),
                                           5))[2]
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        return out

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        assert mesh.init_distributed(device)
        backend = dist.get_backend()
        fsdp = lcm_run(True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    plain = lcm_run(False)
    before = {k: v.detach().cpu().double() for k, v in dit.state_dict().items()}
    same = updates_agree(fsdp["student"], plain["student"], before)
    row = {"backend": backend, "world_size": 1, "batch": batch, "latent": latent,
           "sharded_params": fsdp["sharded"], "params": fsdp["params"],
           "loss_fsdp": fsdp["loss"], "loss": plain["loss"], "update_fsdp_vs_plain": same,
           "rtol": TRAIN_RTOL, "ms_fsdp": fsdp.get("ms", "not measured"),
           "ms_plain": plain.get("ms", "not measured"),
           "peak_gb_fsdp": fsdp.get("peak_gb", "not measured"),
           "peak_gb_plain": plain.get("peak_gb", "not measured"),
           "launches": training_counts_zero("fsdp"), "seconds": time.time() - t0,
           "card": card["nvidia_smi"]}
    emit({"phase": "fsdp", **row})
    if not (fsdp["sharded"] > 0
            and abs(fsdp["loss"] - plain["loss"]) <= TRAIN_RTOL * abs(plain["loss"])
            and same["update_rel_l2_diff"] <= TRAIN_RTOL
            and same["update_max_diff_over_max_update"] <= TRAIN_RTOL):
        raise AssertionError(f"fsdp: the sharded step differs: {row}")
    return row


def train_micro_phase(device, full: bool, card: dict) -> dict:
    """The trainer convergence runs (audiolcm_torch/tools/train_micro.py),
    card against CPU: each run for MICRO_STEPS steps from the same seed-0
    weights and draws (`Draws`) on both. The VAE GAN with disc_start 2 (so
    that the adaptive weight and R1 are live in its last steps) and SGD at
    its lr: with its shipped Adam the card and the CPU parted by 4.7e-4 of
    g_loss's scale within 5 steps, as Adam's first updates, lr g / (|g| +
    eps), turn f32 rounding of near-zero gradients into full-size steps.
    The vocoder GAN on the AM tone, the teacher and its LCM distillation
    (the teacher's 100-step CFG-DDIM endpoint and the 2-step student's
    distance to it at every step) with their shipped optimizers. Every
    metric of every step within TRAIN_RTOL of the CPU's, relative to that
    metric's largest value over the steps; the weights' distance printed.
    The runs' outcomes at their full counts are coin tosses in both
    packages (the JAX tool's passes out of 8 seeds: JAX_PASSES): the
    tool's CLI measures them as pass rates, and
    audiolcm_torch/tools/train_micro_divergence.py where a card run parts
    from a CPU run (PERF.md). 0 K1 / K3 / K4 launches."""
    import numpy as np

    from audiolcm_torch.tools import train_micro as tm
    from audiolcm_torch.tools.train_micro_divergence import weights

    t0 = time.time()
    reset_counts()
    n = MICRO_STEPS if full else 2
    runs = {"vae": lambda **kw: tm.vae_gan_micro(steps=n, disc_start=2, optimizer=lambda p: (
                torch.optim.SGD(p, lr=5e-4)), **kw),
            "vocoder": lambda **kw: tm.vocoder_gan_micro(steps=n, **kw),
            "distill": lambda **kw: tm.lcm_distill_micro(teacher_steps=n, distill_steps=n, **kw)}
    cpu, rows = torch.device("cpu"), {}
    for name, go in runs.items():
        curves, seconds, last = {}, {}, {}
        for dev in (device, cpu):
            t1 = time.time()
            curves[dev] = go(device=dev, verbose=False, check=False,
                             observe=lambda stage, i, state, dev=dev: last.update({dev: state}))
            seconds[dev] = time.time() - t1
        # every per-step metric (the losses; the distillation's distances)
        rel = {k: float(np.max(np.abs(np.subtract(curves[device][k], v)))
                        / max(np.max(np.abs(v)), 1e-30))
               for k, v in curves[cpu].items() if isinstance(v, list) and k != "failures"}
        w_dev, w_cpu = weights(last[device]).double(), weights(last[cpu]).double()
        rows[name] = {"steps": n, "seconds_card": seconds[device], "metric_rel_diff": rel,
                      "metric_rel_diff_max": max(rel.values()),
                      "weights_rel_l2_after": float(torch.linalg.norm(w_dev - w_cpu)
                                                    / torch.linalg.norm(w_cpu)),
                      "within_rtol": max(rel.values()) <= TRAIN_RTOL}
    row = {"runs": rows, "rtol": TRAIN_RTOL, "launches": training_counts_zero("train_micro"),
           "seconds": time.time() - t0, "card": card["nvidia_smi"]}
    emit({"phase": "train_micro", **row})
    if not all(r["within_rtol"] for r in rows.values()):
        raise AssertionError(f"train_micro: a run's card and CPU steps differ: {rows}")
    return row


VARIANT_TARGETS = {"multiw": "contperceptual_multiw", "dis": "contperceptual_dis",
                   "mask": "contperceptual_mask", "vq": "vqperceptual"}
# f32 loss-variant step, card vs CPU: |a - b| <= ATOL + RTOL |b| per loss, the
# CPU tests' bar (the adversarial terms are logit means near 0, where a
# relative bar alone reads f32 rounding of O(1) logits: a mean of 0.0038
# moved 2.5e-7 between the card and the CPU)
VARIANT_LOSS_RTOL = VARIANT_LOSS_ATOL = 1e-5
# eval scorers, card vs CPU: embeddings within this fraction of their largest
# element; the LPAPS distance, MR-STFT, FAD and the CLAP score relative
EVAL_RTOL = 1e-4


def variant_towers(variant: str, cfg: dict):
    """The discriminators `cli.train.run_vae_variant_training` builds for the
    variant: the PatchGAN at the config's disc widths for dis / mask / vq,
    the multi-window tower (hidden 128; windows 16-64 "bn" for multiw,
    32-128 "in" for dis; reduction "stack") for multiw / dis."""
    from audiolcm_torch.models.discriminators import NLayerDiscriminator2D
    from audiolcm_torch.models.multi_window_disc import MultiWindowDiscriminatorWrapper

    lp = cfg["model"]["params"]["lossconfig"]["params"]
    towers = {}
    if variant in ("dis", "mask", "vq"):
        towers["patch"] = NLayerDiscriminator2D(1, lp.get("disc_hidden_size", 64),
                                                lp.get("disc_num_layers", 3))
    if variant in ("multiw", "dis"):
        towers["multi"] = MultiWindowDiscriminatorWrapper(
            [16, 32, 64] if variant == "multiw" else [32, 64, 128],
            cfg["data"]["params"]["mel_num"], norm_type="in" if variant == "dis" else "bn",
            reduction="stack")
    return towers


def train_vae_variants_phase(device, full: bool, card: dict) -> list:
    """The VAE loss variants multiw, dis, mask and vq at configs/
    autoencoder1d.yaml's widths (VAE ch 384, mel 80 x 624, the PatchGAN ndf
    64 with 3 layers, the multi-window tower hidden 128), disc_start 0 so
    that every tower's adaptive weight is live; f32, TF32 off. Mels in
    [-1, 1], the second clip's last 200 frames at the mask variant's
    pad_value -1. Per variant:
    1. one generator + discriminator step on the card and on the CPU at
       batch 2 from the same weights (`init_random_`), posterior noise and
       window starts, SGD at VAE_SGD_LR: the generator step's losses
       within VARIANT_LOSS_ATOL + VARIANT_LOSS_RTOL x |loss| in f32 (its
       adaptive weights, ratios of gradient norms, at TRAIN_RTOL), every
       loss and logit mean within it in f64, the f64 updates
       (`updates_agree`) at TRAIN_RTOL. The discriminator step's f32
       losses (printed) read the f32-updated VAE: with the adaptive weight
       clipped at 1e4 the f32 update is ~1e-4 from f64 on either device,
       and the dis variant's multi-window loss moved 3.3e-4 between them,
       so those are held in f64, as train_vae holds the update;
    2. ms per step at the config's batch 4 with the Adam pair (CUDA
       events, median of 5), peak GB, and the share of the f32 bound
       (`step_flop`'s FLOP of one step over the CUDA cores' f32 rate);
    3. 0 K1 and K3 launches."""
    import copy

    from audiolcm_torch import config as cfg_mod
    from audiolcm_torch.models.multi_window_disc import draw_starts
    from audiolcm_torch.train import vae_losses_extra as V

    rows = []
    cpu = torch.device("cpu")
    for variant in VARIANT_TARGETS:
        t0 = time.time()
        reset_counts()
        cfg = vae_train_config(full, "unused")
        dp = cfg["data"]["params"]
        mel_num, frames, batch = dp["mel_num"], dp["spec_len"], dp["batch_size"]
        torch.manual_seed(80)
        vae = cfg_mod.build_from_target(cfg["model"])
        towers = variant_towers(variant, cfg)
        for i, m in enumerate([vae, *towers.values()]):
            init_random_(m, torch.Generator().manual_seed(84 + i))
        vcfg = V.VariantConfig(variant=variant, disc_start=0)
        g = torch.Generator().manual_seed(81)

        def mels(n):
            mel = torch.rand(n, frames, mel_num, generator=g) * 2.0 - 1.0
            mel[1, -frames // 3:] = vcfg.pad_value
            return mel

        mel = mels(2)
        down = 2 ** len(vae.config.down_layers)
        noise = torch.randn(2, frames // down, vae.config.embed_dim, generator=g)
        starts = (draw_starts(len(towers["multi"].time_lengths), frames, g)
                  if "multi" in towers else None)

        def one_step(dev, dtype=torch.float32):
            st = V.init_variant_state(
                copy.deepcopy(vae).to(dev, dtype),
                {k: copy.deepcopy(t).to(dev, dtype) for k, t in towers.items()}, vcfg,
                optimizer=lambda p: torch.optim.SGD(p, lr=VAE_SGD_LR))
            _, _, step = V.make_variant_gan_steps(vcfg)
            st, m = step(st, mel.to(dev, dtype), noise=noise.to(dev, dtype), starts=starts)
            params = {**{"vae." + k: v for k, v in st.vae.state_dict().items()},
                      **{"discs." + k: v for k, v in st.discs.state_dict().items()
                         if v.is_floating_point()}}
            return {k: float(v) for k, v in m.items()}, {k: v.detach() for k, v in params.items()}

        before = {**{"vae." + k: v.double() for k, v in vae.state_dict().items()},
                  **{"discs." + k: v.double()
                     for k, v in torch.nn.ModuleDict(towers).state_dict().items()
                     if v.is_floating_point()}}
        step_s = {}
        for name, dev, dtype in (("card", device, torch.float32), ("cpu", cpu, torch.float32),
                                 ("card_f64", device, torch.float64),
                                 ("cpu_f64", cpu, torch.float64)):
            t_s = time.time()
            step_s[name] = (one_step(dev, dtype), time.time() - t_s)
        (m_dev, a_dev), (m_cpu, _), (m_dev64, a_dev64), (m_64, a_64) = (
            step_s[k][0] for k in ("card", "cpu", "card_f64", "cpu_f64"))
        # per loss, the gap over its bar (<= 1 passes): in f32 the generator
        # step's, which no update precedes; in f64 every metric. The
        # adaptive weights are ratios of f32 gradient norms over the decoder's
        # last conv: held at TRAIN_RTOL (the dis tower's moved 1.0e-5)
        gen_keys = [k for k in m_cpu if not k.startswith(("train/disc_loss", "train/logits"))]
        rtol_of = lambda k, dtype: (TRAIN_RTOL if "d_weight" in k and dtype == "f32"
                                    else VARIANT_LOSS_RTOL)
        gap = lambda a, b, keys, dt: max(abs(a[k] - b[k]) / (VARIANT_LOSS_ATOL + rtol_of(k, dt)
                                                             * abs(b[k])) for k in keys)
        same = updates_agree(a_dev64, a_64, before)
        row = {"variant": variant, "target": VARIANT_TARGETS[variant], "batch_check": 2,
               "frames": frames, "mel": mel_num, "towers": sorted(towers), "dtype": "float32",
               "tf32": False, "disc_start": 0, "losses_card": m_dev,
               "loss_abs_diff": {k: abs(m_dev[k] - m_cpu[k]) for k in m_cpu},
               "loss_gap_over_bar": gap(m_dev, m_cpu, gen_keys, "f32"),
               "loss_f64_gap_over_bar": gap(m_dev64, m_64, list(m_64), "f64"),
               "rtol": VARIANT_LOSS_RTOL, "atol": VARIANT_LOSS_ATOL, "update_rtol": TRAIN_RTOL,
               "update_f64_card_vs_cpu": same,
               "update_f32_card_vs_f64": updates_agree(a_dev, a_64, before),
               "check_step_s": {k: v[1] for k, v in step_s.items()}}
        live = all(v > 0 for k, v in m_dev.items() if "d_weight" in k)
        if not (row["loss_gap_over_bar"] <= 1.0 and row["loss_f64_gap_over_bar"] <= 1.0
                and same["update_rel_l2_diff"] <= TRAIN_RTOL
                and same["update_max_diff_over_max_update"] <= TRAIN_RTOL and live):
            emit({"phase": "train_vae_variants", **row})
            raise AssertionError(f"train_vae_variants {variant}: card vs CPU step: {row}")
        if device.type == "cuda":
            st = V.init_variant_state(copy.deepcopy(vae).to(device),
                                      {k: copy.deepcopy(t).to(device) for k, t in towers.items()},
                                      vcfg)
            _, _, step = V.make_variant_gan_steps(vcfg)
            mel_b = mels(batch).to(device)
            gen = torch.Generator(device).manual_seed(82)
            run = lambda: step(st, mel_b, gen)
            run()
            flop = step_flop(run)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = timed_steps(run, 5)
            ms = sorted(times)[2]
            row.update(batch=batch, ms_per_step=ms, ms_steps=times,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                       tflop_per_step=flop / 1e12, f32_bound_ms=1e3 * flop / PEAK_F32,
                       share_of_f32_bound=1e3 * flop / PEAK_F32 / ms, card=card["nvidia_smi"])
            del st
        row.update(launches=training_counts_zero(f"train_vae_variants {variant}"),
                   seconds=time.time() - t0)
        emit({"phase": "train_vae_variants", **row})
        rows.append(row)
    return rows


def train_vae_variants_cli_phase(device, full: bool, card: dict) -> dict:
    """`cli.train.main` for one epoch with lossconfig.target
    contperceptual_dis (both towers) at configs/autoencoder1d.yaml's widths
    on 100 + 8 x batch random mels (8 steps): metrics.jsonl with finite val
    losses of both towers, a checkpoint at step 8 holding the VAE and both
    towers, 0 K1 / K3 launches."""
    import os

    import yaml

    from audiolcm_torch.cli import train as cli

    t0 = time.time()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = vae_train_config(full, os.path.join(tmp, "data"))
        cfg["model"]["params"]["lossconfig"]["target"] = (
            "ldm.modules.losses_audio.contperceptual_dis.LPAPSWithDiscriminator")
        dp = cfg["data"]["params"]
        write_manifest(dp["spec_dir_path"], 100 + 8 * dp["batch_size"], dp["mel_num"],
                       dp["spec_len"], seed=86)
        path = os.path.join(tmp, "dis.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        logroot = os.path.join(tmp, "logs")
        cli.main(["-b", path, "-t", "--max_epochs", "1", "-l", logroot, "--device", str(device)])
        lines, ckpts = read_run(logroot)
        (run,) = os.listdir(logroot)
        sd = torch.load(os.path.join(logroot, run, "checkpoints", str(ckpts[-1]), "state.pt"),
                        map_location="cpu", weights_only=True)
    val = [x for x in lines if "val/nll_loss" in x][-1]
    keys = ("val/nll_loss", "val/g_loss", "val/g_multi_loss", "val/d_weight_g",
            "val/d_weight_g_multi", "val/disc_loss", "val/disc_loss_multi", "val/disc_loss_total")
    row = {"target": cfg["model"]["params"]["lossconfig"]["target"], "batch": dp["batch_size"],
           "steps": 8, "checkpoints": ckpts, "epoch_time_s": val["epoch_time_s"],
           **{k: val.get(k) for k in keys},
           "towers_in_checkpoint": sorted({k.split(".")[0] for k in sd["discs"]}),
           "launches": training_counts_zero("train_vae_variants_cli"), "seconds": time.time() - t0}
    emit({"phase": "train_vae_variants_cli", **row})
    if not (ckpts == [8] and all(row[k] is not None and math.isfinite(row[k]) for k in keys)
            and row["towers_in_checkpoint"] == ["multi", "patch"]):
        raise AssertionError(f"train_vae_variants_cli: {row}")
    return row


def rel_to_scale(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def eval_wavs(n: int, seconds: float, seed: int):
    """n synthetic 16 kHz float32 clips: a few partials in noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    return [(0.2 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
             + 0.1 * np.sin(2 * np.pi * rng.uniform(100, 4000) * t)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32) for _ in range(n)]


class StubClapTokenizer:
    """Deterministic (B, 77) ids in place of the CLAP's bert tokenizer."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, captions):
        return torch.stack([(torch.arange(77) * 7 + 3 * len(c)) % 997 for c in captions])


def eval_phase(device, full: bool, card: dict) -> dict:
    """The scorers at full widths on random weights, each against its CPU
    run on the same inputs (EVAL_RTOL), f32 with TF32 off, ms by CUDA
    events (median of 5 unless said): LPAPS on (4, 80, 624) mel pairs;
    MR-STFT on 8 x 159 744 samples; VGGish on 8 ten-second clips (80
    examples) and FAD from them against 8 other clips; the CLAP score of
    one batch of 60 ten-second clips (Cnn14 + BERT-base + projections; the
    host's resample and crop timed apart from the device's embeddings).
    0 K1 / K3 launches. The rehearsal: 16 x 32 mels, 2 x 4000 samples, 2
    one-second clips per VGGish set, 4 CLAP clips and a tiny BERT."""
    import copy

    import numpy as np

    from audiolcm_torch.eval.clap_score import clap_score, prepare_clap_audio
    from audiolcm_torch.eval.fad import embedding_statistics, frechet_distance
    from audiolcm_torch.eval.mrstft import mrstft_loss
    from audiolcm_torch.models.clap import CLAP
    from audiolcm_torch.models.clap_text import BertConfig
    from audiolcm_torch.models.lpaps import LPAPS
    from audiolcm_torch.models.vggish import VGGish

    t0 = time.time()
    reset_counts()
    cpu = torch.device("cpu")
    on_card = device.type == "cuda"
    row: dict = {}
    fails = []

    def both(model, fn):
        """fn(model on a device, device) on the card and on the CPU."""
        outs = []
        for dev in (device, cpu):
            m = copy.deepcopy(model).to(dev).eval().requires_grad_(False)
            with torch.inference_mode():
                outs.append(fn(m, dev))
        return outs

    def timed(fn, iters=5):
        """The median of `iters` calls' CUDA-event ms, after one warm-up."""
        if not on_card:
            return "not measured"
        with torch.inference_mode():
            fn()
            return sorted(timed_steps(fn, iters))[iters // 2]

    # LPAPS
    n_freq, frames = (80, 624) if full else (16, 32)
    lpaps = LPAPS(n_freq)
    init_random_(lpaps, torch.Generator().manual_seed(90))
    g = torch.Generator().manual_seed(91)
    x = torch.rand(4, 1, n_freq, frames, generator=g) * 2 - 1
    y = (x + 0.1 * torch.randn(x.shape, generator=g)).clamp(-1, 1)
    d_dev, d_cpu = both(lpaps, lambda m, dev: m(x.to(dev), y.to(dev)))
    m_dev = copy.deepcopy(lpaps).to(device).eval()
    xd, yd = x.to(device), y.to(device)
    row["lpaps"] = {"shape": list(x.shape), "distance": d_dev.flatten().tolist(),
                    "rel_diff": rel_to_scale(d_dev, d_cpu), "ms": timed(lambda: m_dev(xd, yd))}
    # MR-STFT
    b, n = (8, 159744) if full else (2, 4000)
    w = 0.3 * torch.randn(b, n, generator=g)
    w_hat = w + 0.05 * torch.randn(b, n, generator=g)
    losses = [mrstft_loss(w.to(dev), w_hat.to(dev)) for dev in (device, cpu)]
    wd, whd = w.to(device), w_hat.to(device)
    row["mrstft"] = {"shape": [b, n], "loss": float(losses[0]),
                     "rel_diff": rel_to_scale(losses[0], losses[1]),
                     "ms": timed(lambda: mrstft_loss(wd, whd))}
    # VGGish and FAD
    n_clips, secs = (8, 10.0) if full else (2, 1.0)
    vggish = VGGish()
    init_random_(vggish, torch.Generator().manual_seed(92))
    gen_w = torch.from_numpy(np.stack(eval_wavs(n_clips, secs, 93)))
    bg_w = torch.from_numpy(np.stack(eval_wavs(n_clips, secs, 94)))
    (e_dev, b_dev), (e_cpu, b_cpu) = both(
        vggish, lambda m, dev: (m.embed_waveform(gen_w.to(dev)), m.embed_waveform(bg_w.to(dev))))
    v_dev = copy.deepcopy(vggish).to(device).eval()
    gd = gen_w.to(device)
    fads = [frechet_distance(*embedding_statistics(bg.double().cpu().numpy()),
                             *embedding_statistics(ge.double().cpu().numpy()))
            for ge, bg in ((e_dev, b_dev), (e_cpu, b_cpu))]
    row["vggish"] = {"clips": n_clips, "examples": e_dev.shape[0],
                     "rel_diff": max(rel_to_scale(e_dev, e_cpu), rel_to_scale(b_dev, b_cpu)),
                     "ms": timed(lambda: v_dev.embed_waveform(gd))}
    row["fad"] = {"embedder": "vggish", "fad_card": fads[0], "fad_cpu": fads[1],
                  "rel_diff": abs(fads[0] - fads[1]) / max(abs(fads[1]), 1e-30)}
    # the CLAP score
    n_clap = 60 if full else 4
    bert = BertConfig() if full else BertConfig(vocab_size=1000, hidden_size=16, num_layers=1,
                                                num_heads=2, intermediate_size=32,
                                                max_position_embeddings=80)
    clap = CLAP(bert)
    init_random_(clap, torch.Generator().manual_seed(95))
    wavs = eval_wavs(n_clap, 10.0 if full else 1.0, 96)
    caps = [f"a sound with {i} parts" for i in range(n_clap)]
    tok = StubClapTokenizer()
    t_h = time.perf_counter()
    batch = np.stack([prepare_clap_audio(wv) for wv in wavs])
    host_ms = 1e3 * (time.perf_counter() - t_h)
    scores, embs = [], []
    for dev in (device, cpu):
        m = copy.deepcopy(clap).to(dev).eval().requires_grad_(False)
        seen = []  # one batch of n_clap: the embeddings clap_score scored

        def text_fn(c, m=m, dev=dev):
            seen.append(m.embed_text(tok(c).to(dev)))
            return seen[-1]

        def audio_fn(a, m=m, dev=dev):
            seen.append(m.audio_encoder(torch.as_tensor(a, device=dev)))
            return seen[-1]

        with torch.inference_mode():
            scores.append(clap_score(text_fn, audio_fn, caps, wavs))
        embs.append(seen)
        if dev == device:
            ids, a_dev = tok(caps).to(device), torch.as_tensor(batch, device=device)
            device_ms = timed(lambda: (m.embed_text(ids), m.audio_encoder(a_dev)), iters=3)
    row["clap"] = {"clips": n_clap, "clip_s": 10.0 if full else 1.0, "score_card": scores[0],
                   "score_cpu": scores[1],
                   "rel_diff": abs(scores[0] - scores[1]) / max(abs(scores[1]), 1e-30),
                   "text_emb_rel_diff": rel_to_scale(embs[0][0], embs[1][0]),
                   "audio_emb_rel_diff": rel_to_scale(embs[0][1], embs[1][1]),
                   "host_resample_ms": host_ms, "device_embed_ms": device_ms}
    for name in ("lpaps", "mrstft", "vggish", "fad", "clap"):
        diffs = [v for k, v in row[name].items() if k.endswith("rel_diff")]
        if not all(d <= EVAL_RTOL for d in diffs):
            fails.append(name)
    row.update(rtol=EVAL_RTOL, launches=training_counts_zero("eval"),
               card=card["nvidia_smi"], seconds=time.time() - t0)
    emit({"phase": "eval", **row})
    if fails:
        raise AssertionError(f"eval: card vs CPU beyond {EVAL_RTOL}: {fails}")
    return row


def write_lcm_checkpoint(path: str, cfg_path: str, device) -> float:
    """A reference-format LCM checkpoint at the config's widths from random
    weights (`init_random_`, built on `device`): the student DiT under
    unet.diffusion_model., the VAE, the CLAP-BERT tower with its projection
    and the T5 encoder in their reference layouts, scale_factor 1. Returns
    its size in GB."""
    import os

    from audiolcm_torch import config as cfg_mod

    sys_cfg = cfg_mod.parse_diffusion_config(cfg_mod.load_yaml(cfg_path))
    sd = {"scale_factor": torch.tensor(1.0)}
    gen = torch.Generator(device).manual_seed(97)
    for prefix, build in (("unet.diffusion_model.", sys_cfg.build_dit),
                          ("first_stage_model.", sys_cfg.build_vae),
                          ("cond_stage_model.caption_encoder.", sys_cfg.build_clap_text),
                          ("cond_stage_model.t5_transformer.", sys_cfg.build_t5)):
        with torch.device(device):
            m = build()
        init_random_(m, gen)
        sd.update({prefix + k: v.cpu() for k, v in m.state_dict().items()})
        del m
    torch.save({"state_dict": sd}, path)
    return os.path.getsize(path) / 1e9


def eval_cli_phase(device, full: bool, card: dict) -> dict:
    """`cli.eval_acceptance.main` end to end: a synthetic LCM checkpoint at
    configs/audiolcm.yaml's widths (`write_lcm_checkpoint`) and the 16 kHz
    vocoder directory (best_netG.pt + args.yml), a random CLAP file
    (BERT-base + Cnn14) and a random torchvggish file, stub tokenizers,
    the in-repo AudioCaps TSV with --limit 8 --batch_size 8 (the
    pipeline's defaults: bf16 on the card, no fused stage), and a --gt_dir
    of 8 synthetic 10 s wavs. The one JSON line must hold a finite
    clap_score and fad (VGGish); the wall time split into generate and
    scoring (and the files' writing apart); 0 K1 / K3 launches. The
    rehearsal: the tiny YAML of `diffusion_train_config`, --W 32, 2 clips,
    a tiny CLAP-BERT."""
    import contextlib
    import functools
    import io
    import os

    import yaml
    from scipy.io import wavfile

    from audiolcm_torch import api
    from audiolcm_torch import config as cfg_mod
    from audiolcm_torch.cli import cal_clap_score, eval_acceptance
    from audiolcm_torch.cli import txt2audio_for_lcm as t2a
    from audiolcm_torch.models.clap import CLAP
    from audiolcm_torch.models.clap_text import BertConfig
    from audiolcm_torch.models.vggish import VGGish

    t0 = time.time()
    n = 8 if full else 2
    saved = (api.Tokenizers, cal_clap_score.ClapTokenizer, cal_clap_score.build_clap_scorers,
             t2a.main)
    gen_s = []

    def timed_generate(argv):
        t = time.perf_counter()
        saved[3](argv)
        sync(device)
        gen_s.append(time.perf_counter() - t)

    with tempfile.TemporaryDirectory() as tmp:
        if full:
            cfg_path = "configs/audiolcm.yaml"
            bert = BertConfig()
        else:
            cfg_path = os.path.join(tmp, "tiny.yaml")
            tiny = diffusion_train_config(False, "audiolcm", tmp, "")
            with open(cfg_path, "w") as f:
                yaml.safe_dump(tiny, f)
            bert = BertConfig(vocab_size=1000, hidden_size=16, num_layers=1, num_heads=2,
                              intermediate_size=32, max_position_embeddings=80)
        ckpt = os.path.join(tmp, "lcm.ckpt")
        ckpt_gb = write_lcm_checkpoint(ckpt, cfg_path, device)
        voc_dir = os.path.join(tmp, "vocoder")
        os.makedirs(voc_dir)
        args = vocoder_args(full)
        if not full:
            args["num_mels"] = 16  # the tiny VAE's mel bins
        voc = cfg_mod.build_vocoder_from_args(args)
        init_random_(voc, torch.Generator().manual_seed(98))
        torch.save({"generator": voc.state_dict()}, os.path.join(voc_dir, "best_netG.pt"))
        with open(os.path.join(voc_dir, "args.yml"), "w") as f:
            yaml.safe_dump(args, f)
        clap = CLAP(bert)
        init_random_(clap, torch.Generator().manual_seed(99))
        clap_path = os.path.join(tmp, "clap.pth")
        torch.save({"model": clap.state_dict()}, clap_path)
        vgg = VGGish()
        init_random_(vgg, torch.Generator().manual_seed(100))
        vgg_path = os.path.join(tmp, "vggish.pth")
        torch.save(vgg.state_dict(), vgg_path)
        del clap, vgg, voc
        gt = os.path.join(tmp, "gt")
        os.makedirs(gt)
        for i, wv in enumerate(eval_wavs(n, 10.0 if full else 1.0, 101)):
            wavfile.write(os.path.join(gt, f"gt{i}.wav"), 16000, (wv * 32767).astype("int16"))
        write_s = time.time() - t0
        outdir = os.path.join(tmp, "acc")
        argv = ["-b", cfg_path, "--ckpt", ckpt, "--vocoder-ckpt", voc_dir,
                "--tsv", "audiocaps_test_16000_struct.tsv", "--outdir", outdir,
                "--limit", str(n), "--batch_size", str(n), "--gt_dir", gt,
                "--clap_weights", clap_path, "--vggish_ckpt", vgg_path, "--device", str(device)]
        if not full:
            argv += ["--W", "32"]  # 16 384 samples: one VGGish example per clip
        reset_counts()
        api.Tokenizers = StubTokenizers
        cal_clap_score.ClapTokenizer = StubClapTokenizer
        cal_clap_score.build_clap_scorers = functools.partial(saved[2], text_config=bert)
        t2a.main = timed_generate
        printed = io.StringIO()
        try:
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                out = eval_acceptance.main(argv)
            sync(device)
            wall_s = time.perf_counter() - t1
        finally:
            (api.Tokenizers, cal_clap_score.ClapTokenizer, cal_clap_score.build_clap_scorers,
             t2a.main) = saved
        lines = [x for x in printed.getvalue().splitlines() if x.startswith("{")]
        with open(os.path.join(outdir, "acceptance.json")) as f:
            written = json.load(f)
    row = {"config": "configs/audiolcm.yaml" if full else "tiny", "checkpoint_gb": ckpt_gb,
           "clips": n, "json_lines": len(lines), "acceptance": out,
           "json_matches_file": written == out and len(lines) == 1 and json.loads(lines[0]) == out,
           "files_write_s": write_s, "wall_s": wall_s, "generate_s": gen_s[0] if gen_s else None,
           "scoring_s": wall_s - gen_s[0] if gen_s else None,
           "launches": training_counts_zero("eval_cli"), "seconds": time.time() - t0,
           "card": card["nvidia_smi"]}
    emit({"phase": "eval_cli", **row})
    finite = lambda v: v is not None and math.isfinite(v)
    if not (row["json_matches_file"] and out["n_clips"] == n and finite(out["clap_score"])
            and finite(out["fad"]) and out["fad_embedder"] == "vggish"):
        raise AssertionError(f"eval_cli: {row}")
    return row


def variant_inputs(full: bool, seed: int) -> dict:
    """The variant denoisers' shapes and inputs: latent (8, 312, 20) and
    caption tokens (8, 77, 1024) at full width, with BERT-style ids
    ('|' separators, <start>, <eos>, padding) for the order maps."""
    import numpy as np

    from audiolcm_torch.models.order_dit import SEP_ID

    b, t_lat, n_tok, ctx_dim = (8, 312, 77, 1024) if full else (2, 16, 7, 32)
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, 3000, (b, n_tok))
    ids[:, 0] = 101
    for bi in range(b):
        end = int(rng.integers(n_tok // 2, n_tok))
        ids[bi, rng.choice(np.arange(2, end - 1), min(3, end - 3), replace=False)] = SEP_ID
        ids[bi, end] = 102
        ids[bi, end + 1:] = 0
    orders = [list(rng.integers(0, 99, int(rng.integers(1, 5)))) for _ in range(b)]
    return {"x": torch.randn(b, t_lat, 20 if full else 4, generator=g),
            "t": torch.randint(0, 1000, (b,), generator=g),
            "context": torch.randn(b, n_tok, ctx_dim, generator=g),
            "w": torch.randn(b, 256, generator=g), "ids": ids, "orders": orders}


def vq_ties(z: torch.Tensor, codebook: torch.Tensor, idx_a: torch.Tensor,
            idx_b: torch.Tensor) -> dict:
    """Where two argmins over |z|^2 - 2 z.e + |e|^2 differ: the two codes'
    distances in f64, which must tie at f32 rounding (within 8 f32 ulps of
    |z|^2 + |e|^2)."""
    flat = z.detach().double().cpu().permute(0, 2, 3, 1).reshape(-1, z.shape[1])
    a, b = idx_a.cpu().reshape(-1), idx_b.cpu().reshape(-1)
    rows = (a != b).nonzero().flatten()
    cb = codebook.detach().double().cpu()
    if not len(rows):
        return {"mismatches": 0, "ties": True, "max_gap_over_ulp": 0.0}
    za = flat[rows]
    d = lambda i: (za - cb[i]).square().sum(1)
    scale = za.square().sum(1) + cb[a[rows]].square().sum(1)
    gap = (d(a[rows]) - d(b[rows])).abs() / (scale * torch.finfo(torch.float32).eps)
    return {"mismatches": int(len(rows)), "ties": bool((gap <= 8).all()),
            "max_gap_over_ulp": float(gap.max())}


def variant_models_phase(device, full: bool, card: dict) -> list:
    """The variant modules at full width, random weights from a seed, f32
    with TF32 off, each on the card against the CPU on the same inputs,
    with ms per forward (CUDA events, median of 5): ConcatDiT,
    ConcatOrderDiT and ConcatOrderDiT2 (max_objs 10) at hidden 576, depth
    4, 8 heads, context (8, 77, 1024), latent (8, 312, 20), and
    TxtFlagLargeDiT at the same width (max abs error <= DIT_TOL); the 2D KL
    VAE and the VQ model (8192 codes) at VAE2DConfig's defaults on (4, 1,
    80, 624) mels (moments, latents and decodes of one z relative to scale
    <= MOMENTS_REL_TOL; VQ indices equal, or the two codes tie at f32
    rounding); TransformerTextEncoder at its defaults on batch 8 x 77 ids
    (DIT_TOL). 0 K1 / K3 launches. The rehearsal: tiny widths."""
    import copy

    from audiolcm_torch.models.dit import ConcatDiT
    from audiolcm_torch.models.flag_dit import TxtFlagLargeDiT
    from audiolcm_torch.models.order_dit import (ConcatOrderDiT, ConcatOrderDiT2,
                                                 compute_order_indices, compute_order_insertion)
    from audiolcm_torch.models.text_transformer import TransformerTextEncoder
    from audiolcm_torch.models.vae2d import AutoencoderKL2D, VAE2DConfig, VQModel2D

    t0 = time.time()
    reset_counts()
    cpu = torch.device("cpu")
    on_card = device.type == "cuda"
    rows, fails = [], []
    inp = variant_inputs(full, seed=100)
    dit_kw = ({} if full else dict(in_channels=4, context_dim=32, hidden_size=32, depth=1,
                                   num_heads=4))
    max_objs = 10 if full else 3
    order_index = torch.from_numpy(compute_order_indices(inp["ids"], inp["orders"]))
    src, oid = map(torch.from_numpy, compute_order_insertion(inp["ids"], inp["orders"],
                                                             max_objs=max_objs))
    x, t, ctx, w = inp["x"], inp["t"], inp["context"], inp["w"]

    def on(dev, *args):
        return [a.to(dev) for a in args]

    def timed(fn):
        if not on_card:
            return "not measured"
        with torch.inference_mode():
            fn()
            return sorted(timed_steps(fn, 5))[2]

    def pair(name, model, run, seed, tol, rel=False, extra=None, held=None):
        """run(model, dev) -> an output tensor or a tuple of them; the card's
        (the first `held` of them, or all) against the CPU's, then the card's
        ms; extra(card model, outputs) adds to the row (and "ok")."""
        init_random_(model, torch.Generator().manual_seed(seed))
        outs = {}
        for dev in (device, cpu):
            m = copy.deepcopy(model).to(dev).eval().requires_grad_(False)
            with torch.inference_mode():
                outs[dev.type] = run(m, dev)
            if dev == device:
                m_dev = m
        got, want = (outs[device.type], outs["cpu"])
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = [rel_to_scale(a, b) if rel else float((a.double().cpu() - b.double()).abs().max())
                for a, b in zip(got[:held], want[:held])]
        row = {"model": name, "shape": list(want[0].shape),
               ("max_rel_err" if rel else "max_abs_err"): max(errs), "tol": tol,
               "max_abs_out": float(want[0].abs().max()),
               "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
               "ms": timed(lambda: run(m_dev, device))}
        row.update(extra(m_dev, outs) if extra else {})
        ok = max(errs) <= tol and all(bool(torch.isfinite(a).all()) for a in got[:held])
        if not ok or not row.get("ok", True):
            fails.append(name)
        rows.append(row)
        emit({"phase": "variant_models", **row, "card": card["nvidia_smi"]})

    pair("ConcatDiT", ConcatDiT(**dit_kw),
         lambda m, d: m(*on(d, x, t, ctx, w)), 101, DIT_TOL)
    pair("ConcatOrderDiT", ConcatOrderDiT(**dit_kw),
         lambda m, d: m(*on(d, x, t, ctx, order_index, w)), 102, DIT_TOL)
    pair("ConcatOrderDiT2", ConcatOrderDiT2(**dit_kw),
         lambda m, d: m(*on(d, x, t, ctx, src, oid, w)), 103, DIT_TOL)
    pair("TxtFlagLargeDiT", TxtFlagLargeDiT(**dit_kw),
         lambda m, d: m(*on(d, x, t, ctx)), 104, DIT_TOL)

    vae_cfg = VAE2DConfig() if full else VAE2DConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                                     resolution=16)
    g = torch.Generator().manual_seed(105)
    mel = torch.randn((4, 1, 80, 624) if full else (1, 1, 16, 24), generator=g)
    down = 2 ** (len(vae_cfg.ch_mult) - 1)
    z = torch.randn((mel.shape[0], vae_cfg.embed_dim, mel.shape[2] // down,
                     mel.shape[3] // down), generator=g)
    pair("AutoencoderKL2D", AutoencoderKL2D(vae_cfg),
         lambda m, d: (m.encode_moments(mel.to(d)), m.decode(z.to(d))), 106, MOMENTS_REL_TOL,
         rel=True)

    def vq_run(m, d):
        h = m.quant_conv(m.encoder(mel.to(d)))
        quant, loss, idx = m.quantize(h)
        return h, quant, m.decode(z.to(d)), loss, idx.to(torch.float64)

    def vq_extra(m_dev, outs):
        h_cpu, idx_dev, idx_cpu = outs["cpu"][0], outs[device.type][4], outs["cpu"][4]
        ties = vq_ties(h_cpu, m_dev.quantize.embedding.weight, idx_dev.long(), idx_cpu.long())
        loss_rel = abs(float(outs[device.type][3]) - float(outs["cpu"][3])) / abs(
            float(outs["cpu"][3]))
        return {"n_embed": m_dev.quantize.n_embed, "codes_used": int(idx_cpu.unique().numel()),
                "index_check": ties, "loss_rel_diff": loss_rel,
                "ok": ties["ties"] and loss_rel <= MOMENTS_REL_TOL}

    # the pre-quantization latent, the quantized latent and a decode at
    # MOMENTS_REL_TOL; the loss and the indices in vq_extra
    pair("VQModel2D", VQModel2D(dataclasses.replace(vae_cfg, double_z=False),
                                n_embed=8192 if full else 64),
         vq_run, 107, MOMENTS_REL_TOL, rel=True, extra=vq_extra, held=3)

    text_kw = {} if full else dict(vocab_size=100, dim=32, depth=1, num_heads=4)
    tenc = TransformerTextEncoder(**text_kw)
    ids = torch.randint(0, tenc.token_emb.num_embeddings, (8 if full else 2, 77),
                        generator=torch.Generator().manual_seed(108))
    pair("TransformerTextEncoder", tenc, lambda m, d: m(ids.to(d)), 109, DIT_TOL)

    launches = training_counts_zero("variant_models")
    emit({"phase": "variant_models", "models": len(rows), "launches": launches,
          "card": card["nvidia_smi"], "seconds": time.time() - t0})
    if fails:
        raise AssertionError(f"variant_models: card vs CPU beyond the bars: {fails}")
    return rows


def ldm_variants_phase(device, full: bool, card: dict) -> list:
    """The auxiliary LDM trainers at full width, f32 with TF32 off, random
    weights from a seed, channels-first latents (8, 20, 312): the inpaint
    step (ConcatDiT2MLP with 41 channels in, 20 out; c_concat = the masked
    latent and a 624-frame mask resized to 312; context 154 x 1024), the
    order step (ConcatOrderDiT over 77 caption tokens with orders from
    compute_order_indices), the classifier step (a linear head over the
    time-pooled latent, 527 classes) and the noisy-accuracy sweep at
    log_every_t 100. Each step once on the card and the CPU with injected
    draws and SGD lr 1: the loss and the update (`updates_agree`, L2 and
    largest element) at TRAIN_RTOL in f32 (the teacher_train row shows an
    eps-MSE step's f32 update reproducible to ~1e-6); the sweep's
    accuracies equal. Then the shipped optimisers (the teacher's clip +
    AdamW chain, the classifier's AdamW): ms per step (CUDA events, median
    of 5), peak GB, and the f32 bound of the step's FLOP (`step_flop`).
    0 K1 / K3 launches."""
    import copy

    from audiolcm_torch.diffusion.schedule import NoiseSchedule
    from audiolcm_torch.models.dit import ConcatDiT2MLP
    from audiolcm_torch.models.order_dit import ConcatOrderDiT, compute_order_indices
    from audiolcm_torch.train import ldm_variants as V
    from audiolcm_torch.train.teacher import TeacherConfig, init_teacher_state

    t0 = time.time()
    reset_counts()
    cpu = torch.device("cpu")
    on_card = device.type == "cuda"
    schedule = NoiseSchedule.linear()
    inp = variant_inputs(full, seed=110)
    b = inp["x"].shape[0]
    z_ch, t_lat = inp["x"].shape[2], inp["x"].shape[1]
    dit_kw = ({} if full else dict(context_dim=32, hidden_size=32, depth=1, num_heads=4))
    g = torch.Generator().manual_seed(111)
    z = torch.randn(b, z_ch, t_lat, generator=g)
    mask = (torch.rand(b, 1, 2 * t_lat, generator=g) > 0.5).float()
    c_concat = V.build_inpaint_cond(torch.randn(b, z_ch, t_lat, generator=g), mask)
    ctx154 = torch.randn(b, 2 * inp["context"].shape[1], inp["context"].shape[2], generator=g)
    order_index = torch.from_numpy(compute_order_indices(inp["ids"], inp["orders"]))
    n_classes = 527 if full else 11
    targets = torch.randint(0, n_classes, (b,), generator=g)
    draws = {"t": torch.randint(0, 1000, (b,), generator=g),
             "noise": torch.randn(z.shape, generator=g)}
    sgd = lambda p: torch.optim.SGD(p, lr=1.0)
    rows, fails = [], []

    def channels_first(m, x, t, *cond):
        return m(x.transpose(1, 2), t, *cond).transpose(1, 2)

    def pool_head(m, x, t):
        return m(x.mean(-1))

    cases = {
        "inpaint": (ConcatDiT2MLP(in_channels=2 * z_ch + 1, out_channels=z_ch, **dit_kw),
                    lambda: V.make_inpaint_step(channels_first, schedule, TeacherConfig()),
                    (c_concat, ctx154), init_teacher_state, TeacherConfig()),
        "order": (ConcatOrderDiT(in_channels=z_ch, **dit_kw),
                  lambda: V.make_order_step(channels_first, schedule, TeacherConfig()),
                  (inp["context"], order_index), init_teacher_state, TeacherConfig()),
        "classifier": (torch.nn.Linear(z_ch, n_classes),
                       lambda: V.make_classifier_step(pool_head, schedule,
                                                      V.ClassifierConfig(n_classes)),
                       (targets,), V.init_classifier_state, V.ClassifierConfig(n_classes)),
    }
    for seed, (kind, (model, make_step, cond, init_state, cfg)) in enumerate(cases.items()):
        init_random_(model, torch.Generator().manual_seed(112 + seed))
        before = {k: v.detach().double() for k, v in model.state_dict().items()}
        out = {}
        for dev in (device, cpu):
            state = init_state(copy.deepcopy(model).to(dev), cfg, optimizer=sgd)
            state, m = make_step()(state, z.to(dev), *[c.to(dev) for c in cond],
                                   **{k: v.to(dev) for k, v in draws.items()})
            out[dev.type] = (float(m["train/loss"]), {k: v.detach() for k, v in
                                                      state.model.state_dict().items()})
        (loss_dev, after_dev), (loss_cpu, after_cpu) = out[device.type], out["cpu"]
        same = updates_agree(after_dev, after_cpu, before)
        row = {"step": kind, "batch": b, "latent": [z_ch, t_lat], "dtype": "float32",
               "tf32": False, "loss_card": loss_dev, "loss_cpu": loss_cpu,
               "loss_rel_diff": abs(loss_dev - loss_cpu) / abs(loss_cpu), "rtol": TRAIN_RTOL,
               "update_f32_card_vs_cpu": same}
        if not (row["loss_rel_diff"] <= TRAIN_RTOL and same["update_rel_l2_diff"] <= TRAIN_RTOL
                and same["update_max_diff_over_max_update"] <= TRAIN_RTOL):
            fails.append(kind)
        if on_card:  # the shipped optimisers
            state = init_state(copy.deepcopy(model).to(device), cfg)
            step = make_step()
            gen = torch.Generator(device).manual_seed(113)
            args = [z.to(device)] + [c.to(device) for c in cond]
            run = lambda: step(state, *args, generator=gen)  # noqa: E731
            run()
            flop = step_flop(run)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = timed_steps(run, 5)
            row.update(ms_per_step=sorted(times)[2], ms_steps=times,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                       tflop_per_step=flop / 1e12, f32_bound_ms=1e3 * flop / PEAK_F32)
        if kind == "classifier":  # the sweep with the card's SGD-stepped head
            heads = {}
            noises = [torch.randn(z.shape, generator=g) for _ in range(0, 1000, 100)]
            sweeps = {}
            for dev in (device, cpu):
                head = copy.deepcopy(model).to(dev)
                head.load_state_dict({k: v.to(dev) for k, v in after_cpu.items()})
                sweeps[dev.type] = V.noisy_accuracy_sweep(pool_head, head, z.to(dev),
                                                          targets.to(dev), schedule,
                                                          log_every_t=100, noises=noises)
                heads[dev.type] = head
            row["sweep"] = {"levels": len(sweeps["cpu"]), "card": sweeps[device.type],
                            "equal": sweeps[device.type] == sweeps["cpu"]}
            if on_card:
                zd, td, hd = z.to(device), targets.to(device), heads["cuda"]
                nd = [n.to(device) for n in noises]
                row["sweep"]["ms"] = sorted(timed_steps(lambda: V.noisy_accuracy_sweep(
                    pool_head, hd, zd, td, schedule, log_every_t=100, noises=nd), 5))[2]
            if not row["sweep"]["equal"]:
                fails.append("sweep")
        rows.append(row)
        emit({"phase": "ldm_variants", **row, "card": card["nvidia_smi"]})
    launches = training_counts_zero("ldm_variants")
    emit({"phase": "ldm_variants", "steps": len(rows), "launches": launches,
          "card": card["nvidia_smi"], "seconds": time.time() - t0})
    if fails:
        raise AssertionError(f"ldm_variants: card vs CPU beyond the bars: {fails}")
    return rows


def open_clap_inputs(full: bool, seed: int) -> dict:
    """The LAION CLAP's inputs: roberta ids (8, 77) and (8, 512) as its
    tokenizer pads them (<s> 0, text, </s> 2, then pad 1 to a ragged
    length; one row full) with their masks; 8 ten-second 48 kHz waveforms
    (480 000 samples); a mel_fusion stack (8, 4, 1001, 64) with `longer`
    mixed. The rehearsal: tiny widths, batch 2."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    b, vocab, samples, frames, mel = (8, 50265, 480000, 1001, 64) if full else (2, 60, 8000,
                                                                               101, 16)

    def roberta_ids(t):
        ids = rng.integers(3, vocab, (b, t))
        ids[:, 0] = 0
        for row in range(b):
            n = t if row == 0 else int(rng.integers(3, t))
            ids[row, n - 1], ids[row, n:] = 2, 1
        ids = torch.from_numpy(ids)
        return ids, (ids != 1).long()

    tokens, sentence = roberta_ids(77), roberta_ids(512)
    return {"tokens": tokens, "sentence": sentence,
            "waveform": 0.1 * torch.randn(b, samples, generator=g),
            "mel_fusion": torch.randn(b, 4, frames, mel, generator=g),
            "longer": torch.arange(b) % 2 == 0}


def open_clap_phase(device, full: bool, card: dict) -> list:
    """The LAION CLAP at full width, random weights from a seed (BatchNorm
    running statistics random too), f32 with TF32 off, each case on the
    card against the CPU on the same inputs, ms per call (CUDA events,
    median of 5), FLOP (`step_flop`) and the share of the 67 TFLOP/s f32
    bound: `laion_tokens` (FrozenLAIONCLAPEmbedder built from its registry
    node: HTSAT-tiny aff_2d + roberta-base, the audio side dropped;
    per-token encode of (8, 77) ids with ragged padded tails, max abs <=
    TEXT_TOL), `laion_sentence` (FrozenLAIONCLAPSetenceEmbedder on (8, 512)
    ids: unit vectors, TEXT_TOL), `htsat_waveform` (OpenClap HTSAT-tiny
    aff_2d: the audio embedding of 8 x 480 000 samples, the tower's outputs
    at AUDIO_REL_TOL of scale), `htsat_fusion` (its 6-tuple forward on
    mel_fusion (8, 4, 1001, 64) with `longer` mixed and (8, 77) ids) and
    `pann14` (PANN-14's audio embedding of the 8 waveforms); the image-CLIP
    towers `rn50` (ModifiedResNet RN50) and `vit_b_32` (VisualTransformer
    ViT-B-32) on (8, 3, 224, 224) images, at VISION_REL_TOL of scale. 0 K1
    / K3 launches. The rehearsal: tiny widths through a patched
    create_model."""
    import contextlib
    import copy
    from unittest import mock

    from audiolcm_torch import config as C
    from audiolcm_torch.models.open_clap import embedders as E
    from audiolcm_torch.models.open_clap import factory, htsat, model as M, pann, text_towers
    from audiolcm_torch.models.open_clap import vision_towers

    t0 = time.time()
    reset_counts()
    cpu = torch.device("cpu")
    on_card = device.type == "cuda"
    inp = open_clap_inputs(full, seed=120)
    rows, fails = [], []
    if full:
        clap_cfg = lambda audio, fusion: factory.build_config(audio, "roberta", fusion != "None",
                                                              fusion)
        patched = contextlib.nullcontext()
    else:  # tiny towers in place of the factory's published ones
        def clap_cfg(audio, fusion):
            kw = dict(enable_fusion=fusion != "None", fusion_type=fusion)
            a = (htsat.HTSATConfig(spec_size=64, embed_dim=16, depths=(2, 2, 2),
                                   num_heads=(2, 2, 2), window_size=4, num_classes=10,
                                   mel_bins=16, sample_rate=8000, hop_size=80,
                                   window_size_stft=256, **kw)
                 if audio.startswith("HTSAT") else
                 pann.PannConfig(model_name="Cnn6", sample_rate=8000, window_size=256,
                                 hop_size=80, **kw))
            return M.OpenClapConfig(embed_dim=64 if audio.startswith("HTSAT") else 512, audio=a,
                                    joint_embed_shape=24, text_config=text_towers.RobertaConfig(
                                        vocab_size=60, hidden_size=16, num_layers=1, num_heads=2,
                                        intermediate_size=32))

        patched = mock.patch.object(E, "create_model", lambda a, t, w="", **kw: (
            M.OpenClap(clap_cfg(a, kw["fusion_type"])), None))

    def randomize(module, seed):
        gen = torch.Generator().manual_seed(seed)
        init_random_(module, gen)
        with torch.no_grad():
            for m in module.modules():
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.running_mean.normal_(0.0, 0.1, generator=gen)
                    m.running_var.uniform_(0.5, 1.5, generator=gen)
        return module.eval().requires_grad_(False)

    def case(name, module, run, tol, rel, extra=None):
        """run(module, dev) -> outputs (a tensor or a tuple); the card's
        against the CPU's (max abs, or relative to each output's scale),
        ms, FLOP and the share of the f32 bound."""
        outs = {}
        for dev in (device, cpu):
            m = module if dev == cpu else copy.deepcopy(module).to(dev)
            with torch.inference_mode():
                outs[dev.type] = run(m, dev)
            if dev == device:
                m_dev = m
        got = outs[device.type] if isinstance(outs[device.type], tuple) else (outs[device.type],)
        want = outs["cpu"] if isinstance(outs["cpu"], tuple) else (outs["cpu"],)
        errs = [rel_to_scale(a, b) if rel else float((a.double().cpu() - b.double()).abs().max())
                for a, b in zip(got, want)]
        row = {"case": name, "shape": list(want[0].shape),
               ("max_rel_err" if rel else "max_abs_err"): max(errs), "tol": tol,
               "max_abs_out": float(want[0].abs().max()),
               "params_m": sum(p.numel() for p in module.parameters()) / 1e6}
        if on_card:
            fn = lambda: run(m_dev, device)  # noqa: E731
            with torch.no_grad():  # inference mode bypasses step_flop's dispatch mode
                flop = step_flop(fn)
            with torch.inference_mode():
                fn()
                ms = sorted(timed_steps(fn, 5))[2]
            row.update(ms=ms, tflop=flop / 1e12, f32_bound_ms=1e3 * flop / PEAK_F32,
                       share_of_f32_bound=1e3 * flop / PEAK_F32 / ms)
        else:
            row.update(ms="not measured")
        row.update(extra(outs) if extra else {})
        ok = (max(errs) <= tol and all(bool(torch.isfinite(a).all()) for a in got)
              and row.get("ok", True))
        if not ok:
            fails.append(name)
        rows.append(row)
        emit({"phase": "open_clap", **row, "card": card["nvidia_smi"]})

    on = lambda dev, *xs: [x.to(dev) for x in xs]  # noqa: E731
    enc = "ldm.modules.encoders.modules."
    with patched:
        tokens = randomize(C.build_from_target({"target": enc + "FrozenLAIONCLAPEmbedder",
                                                "params": {}}), 121)
        sentence = randomize(C.build_from_target(
            {"target": enc + "FrozenLAIONCLAPSetenceEmbedder", "params": {}}), 122)
    unit = lambda outs: {  # noqa: E731
        "max_norm_dev_from_1": float((outs["cpu"].norm(dim=-1) - 1).abs().max()),
        "ok": bool((outs["cpu"].norm(dim=-1) - 1).abs().max() <= 1e-5)}
    case("laion_tokens", tokens, lambda m, d: m.encode_ids(*on(d, *inp["tokens"])),
         TEXT_TOL, rel=False)
    case("laion_sentence", sentence, lambda m, d: m.encode_ids(*on(d, *inp["sentence"])),
         TEXT_TOL, rel=False, extra=unit)

    def audio(m, d):
        """The unit audio embedding and the tower's outputs, one tower run."""
        out = m.encode_audio(inp["waveform"].to(d))
        z = m.audio_projection(out["embedding"])
        return (z / z.norm(dim=-1, keepdim=True), *out.values())

    clap = randomize(M.OpenClap(clap_cfg("HTSAT-tiny", "aff_2d")), 123)
    case("htsat_waveform", clap, audio, AUDIO_REL_TOL, rel=True)
    case("htsat_fusion", clap, lambda m, d: m(
        mel_fusion=inp["mel_fusion"].to(d), longer=inp["longer"].to(d),
        input_ids=inp["tokens"][0].to(d), attention_mask=inp["tokens"][1].to(d)),
        AUDIO_REL_TOL, rel=True)
    del clap
    pann14 = randomize(M.OpenClap(clap_cfg("PANN-14", "None")), 124)
    case("pann14", pann14, audio, AUDIO_REL_TOL, rel=True)
    del pann14

    # the image-CLIP towers the reference keeps and never builds
    if full:
        towers = {"rn50": vision_towers.build_vision_tower("RN50"),
                  "vit_b_32": vision_towers.build_vision_tower("ViT-B-32")}
    else:
        towers = {"rn50": vision_towers.ModifiedResNet((1, 1, 1, 1), 16, 4, 32, 8),
                  "vit_b_32": vision_towers.VisualTransformer(32, 8, 32, 2, 4, 16)}
    images = torch.randn(inp["waveform"].shape[0], 3, 224 if full else 32, 224 if full else 32,
                         generator=torch.Generator().manual_seed(125))
    for i, (name, tower) in enumerate(towers.items()):
        case(name, randomize(tower, 126 + i), lambda m, d: m(images.to(d)), VISION_REL_TOL,
             rel=True)

    launches = training_counts_zero("open_clap")
    emit({"phase": "open_clap", "cases": len(rows), "launches": launches,
          "card": card["nvidia_smi"], "seconds": time.time() - t0})
    if fails:
        raise AssertionError(f"open_clap: card vs CPU beyond the bars: {fails}")
    return rows


def _tensors(sd) -> list:
    """Every tensor of a nested state dict, in a fixed order."""
    if isinstance(sd, torch.Tensor):
        return [sd]
    if isinstance(sd, dict):
        return [t for k in sorted(sd, key=str) for t in _tensors(sd[k])]
    if isinstance(sd, (list, tuple)):
        return [t for v in sd for t in _tensors(v)]
    return []


# K7 at Moonlight-16B-A3B's widths: experts, top-k, hidden, expert width
MOE_WIDTHS = (64, 6, 2048, 1408)
MOE_TINY = (8, 2, 32, 16)  # the rehearsal's
MOE_SCALE = 2.446  # Moonlight's routed_scaling_factor
# the cell's uneven routing: per-expert offsets N(0, 1) x MOE_SKEW on uniform
# scores; at 128 tokens the busiest expert gets 74 rows, 17 of 64 get none
# (the benchmark's random tower: 76 rows, some none, in its first expert layer)
MOE_SKEW, MOE_SEED = 0.15, 0


def moe_routing(tokens: int, e: int, k: int, skew: float, seed: int) -> tuple:
    """(idx (T, k) int64, w (T, k) f32) on the CPU from the seed: the top k
    of uniform scores plus skew x a per-expert normal offset (skew 0: every
    expert about T k / e rows); the weights positive, normalised and scaled
    as the router's."""
    g = torch.Generator().manual_seed(seed)
    offset = torch.randn(e, generator=g)
    idx = (torch.rand(tokens, e, generator=g) + skew * offset).topk(k, dim=-1)[1]
    w = torch.rand(tokens, k, generator=g) + 0.5
    return idx, w / w.sum(-1, keepdim=True) * MOE_SCALE


def moe_bound_ms(idx: torch.Tensor, e: int, d: int, inter: int) -> tuple:
    """K7's least time for one call: the weights of the experts that get a
    row and the tokens' input, residual, shared output and output (bf16)
    over the HBM rate, against the routed products over the bf16 peak."""
    tokens, k = idx.shape
    active = int((torch.bincount(idx.flatten().cpu(), minlength=e) > 0).sum())
    t_bytes = 2 * (active * 3 * d * inter + 4 * tokens * d) / HBM
    t_ops = 2 * tokens * k * 3 * d * inter / PEAK_BF16
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations", active


def moe_kernel_phase(device, rehearsal: bool, card: dict) -> list:
    """K7 (nn/moe_experts.py) against the plain per-expert loop at
    Moonlight's widths (64 experts of 2048 -> 1408, top 6), 128 tokens (the
    cell's request) and 1024, each under even routing and under the cell's
    uneven routing (MOE_SKEW): bf16, its mean error against the f32 walk of
    its algorithm at most 1.02x the plain bf16 loop's; the on-card dispatch
    equal to `dispatch`; 4 launches a call (`moe_experts`); ms by CUDA
    events, K7's device ms (every k7_ kernel) in the profiler, the bound
    from the inputs (`moe_bound_ms`), the plain loop's ms. The rehearsal
    holds the walk against the plain loop in f32 at tiny widths."""
    from audiolcm_torch import obs
    from audiolcm_torch.nn import moe_experts as M

    e, k, d, inter = MOE_TINY if rehearsal else MOE_WIDTHS
    rows = []
    for tokens in ((9, 40) if rehearsal else (128, 1024)):
        for skew in (0.0, MOE_SKEW):
            idx, w = moe_routing(tokens, e, k, skew, MOE_SEED)
            idx, w = idx.to(device), w.to(device)
            g = torch.Generator(device).manual_seed(tokens)
            x, res, shared = (torch.randn(tokens, d, generator=g, device=device)
                              for _ in range(3))
            stacked = tuple((torch.randn(e, n, kk, generator=g, device=device) * kk ** -0.5)
                            for n, kk in ((inter, d), (inter, d), (d, inter)))
            counts = torch.bincount(idx.flatten().cpu(), minlength=e)
            row = {"tokens": tokens, "experts": e, "top_k": k, "hidden": d, "width": inter,
                   "skew": skew, "rows_max": int(counts.max()), "rows_min": int(counts.min())}
            with torch.inference_mode():
                if rehearsal:
                    walk = M.routed_experts_walk(x, idx, w, stacked, res, shared)
                    plain32 = res + shared + M.routed_experts_plain(x, idx, w,
                                                                    list(zip(*stacked)))
                    row["walk_vs_plain_f32_max_abs"] = (walk - plain32).abs().max().item()
                    emit({"phase": "moe_kernel", **row})
                    if not row["walk_vs_plain_f32_max_abs"] <= F32_TOL:
                        raise AssertionError(f"moe_kernel: {row}")
                    rows.append(row)
                    continue
                xb, rb, sb = (t.bfloat16() for t in (x, res, shared))
                sbf = tuple(t.bfloat16().contiguous() for t in stacked)
                gold = M.routed_experts_walk(xb.float(), idx, w, tuple(t.float() for t in sbf),
                                             rb.float(), sb.float())
                k7 = lambda: M.routed_experts(xb, idx, w, sbf, rb, sb)  # noqa: E731
                plain = lambda: rb + (M.routed_experts_plain(  # noqa: E731
                    xb, idx, w, list(zip(*sbf))).bfloat16() + sb)
                n0 = obs.counters().get(M.COUNTER, 0)
                got = k7()
                sync(device)
                row["launches"] = obs.counters().get(M.COUNTER, 0) - n0
                row["dispatch_equal"] = all(torch.equal(a.int(), b) for a, b in zip(
                    M.dispatch(idx, e), M.dispatch_on_card(idx, e)))
                row["bf16_mean_err"] = (got.float() - gold).abs().mean().item()
                row["plain_bf16_mean_err"] = (plain().float() - gold).abs().mean().item()
                row["ms"] = event_ms(k7, iters=20, warmup=2)
                row["device_ms"] = kernel_device_ms(k7, "k7_", 10)
                row["plain_ms"] = event_ms(plain, iters=3)
                row["bound_ms"], row["bound_by"], row["experts_with_rows"] = moe_bound_ms(
                    idx, e, d, inter)
                if not row["device_ms"] > 0:
                    raise AssertionError(f"moe_kernel: the profiler saw no k7_ kernel: {row}")
                row.update(bound_share=row["bound_ms"] / row["device_ms"], card=card["nvidia_smi"])
            emit({"phase": "moe_kernel", **row})
            if not (row["launches"] == 4 and row["dispatch_equal"]
                    and row["bf16_mean_err"] <= 1.02 * row["plain_bf16_mean_err"]):
                raise AssertionError(f"moe_kernel: {row}")
            rows.append(row)
            del x, res, shared, stacked, sbf, gold
    return rows


def moonlight_tower(device, full: bool, dtype):
    """Moonlight-16B-A3B's tower (models/moe_llm.py; the rehearsal's at tiny
    widths: 2 layers, one dense, 8 experts top 2) built on the meta device
    and its weights drawn on `device` in `dtype` tensor by tensor, as
    init_random_ draws them (fan-in normal matrices, norm scales ~1): its
    15.6 B parameters are never made in f32."""
    from audiolcm_torch.models.moe_llm import MoELLM, MoELLMConfig

    cfg = MoELLMConfig() if full else MoELLMConfig(
        vocab_size=100, hidden_size=32, intermediate_size=48, moe_intermediate_size=16,
        num_hidden_layers=2, num_attention_heads=2, n_routed_experts=8, n_shared_experts=1,
        num_experts_per_tok=2, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
        v_head_dim=8)
    with torch.device("meta"):
        tower = MoELLM(cfg)
    gen, sd = torch.Generator(device).manual_seed(5), {}
    for name, t in tower.state_dict().items():
        p = torch.empty(t.shape, dtype=dtype, device=device)
        if p.dim() >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
        elif name.endswith("weight"):
            p.normal_(1.0, 0.02, generator=gen)
        else:
            p.normal_(0.0, 0.02, generator=gen)
        sd[name] = p
    tower.load_state_dict(sd, strict=True, assign=True)
    return tower


def moonlight_generate_phase(device, full: bool, card: dict) -> dict:
    """The LCM generate with Moonlight as its third caption tower (the cell
    moonlight_lcm_b1_10s's path, random weights): batch 1, 10 s, 77 + 77 +
    128 tokens, bf16, captured by api.prewarm_buckets; the launch counts of
    one replay (K7 104: 4 in each of 26 expert layers; K1 2, K5 73, K6 72 as
    without the tower), the replay against the eager waveform
    (REPLAY_TOL), replay and eager ms, peak GB. The rehearsal: the eager
    generate at tiny widths on the CPU (no K7: the plain loop)."""
    from audiolcm_torch.models.dit import ConcatDiT2MLP
    from audiolcm_torch.pipeline import AudioLCMPipeline

    dtype = torch.bfloat16 if full else torch.float32
    mods = build_modules(device, full)
    tower = moonlight_tower(device, full, dtype)
    kw = dit_kwargs(full)
    with torch.device(device):
        mods.dit = ConcatDiT2MLP(**kw, llm_context_dim=tower.config.hidden_size)
    init_random_(mods.dit, torch.Generator(device).manual_seed(6))
    mods.llm = tower
    pipe = AudioLCMPipeline(mods, compute_dtype=dtype, device=device)
    batch, latent, tok, llm_len = 1, (312 if full else 16), 77, 128
    ids = token_ids(mods, batch, tok, seed=11)
    llm_ids = torch.randint(0, tower.config.vocab_size, (batch, llm_len),
                            generator=torch.Generator().manual_seed(12))
    gen = lambda: torch.Generator(device).manual_seed(31)  # noqa: E731
    run = lambda: pipe.generate(ids[0], ids[1], latent, generator=gen(),  # noqa: E731
                                llm_ids=llm_ids)
    row = {"batch": batch, "mel": 2 * latent, "tokens": tok, "llm_tokens": llm_len,
           "tower_params": sum(p.numel() for p in tower.parameters())}
    if not full:
        reset_counts()
        with torch.inference_mode():
            wav, _ = run()
        row.update(counts_eager=read_counts(), wav_shape=list(wav.shape))
        emit({"phase": "moonlight_generate", **row})
        if not (bool(torch.isfinite(wav).all()) and row["counts_eager"] == counts_with()):
            raise AssertionError(f"moonlight_generate: {row}")
        return row
    from audiolcm_torch.api import prewarm_buckets

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    hows = prewarm_buckets(pipe, batch_sizes=(batch,), mel_buckets=(2 * latent,),
                           llm_len=llm_len)
    row["capture_s"] = time.perf_counter() - t0
    with torch.inference_mode():
        reset_counts()
        wav_r, _ = run()
        sync(device)
        row["counts_per_replay"] = read_counts()
        row["replay_ms"] = median_ms(run)
        graphs = dict(pipe._graphs)
        pipe._graphs.clear()
        reset_counts()
        wav_e, _ = run()
        sync(device)
        row["counts_eager"] = read_counts()
        row["eager_ms"] = median_ms(run)
        pipe._graphs.update(graphs)
    row.update(hows={str(k): v for k, v in hows.items()},
               replay_vs_eager_max_abs=(wav_r - wav_e).abs().max().item(), tol=REPLAY_TOL,
               peak_gb=torch.cuda.max_memory_allocated(device) / 1e9, card=card["nvidia_smi"])
    emit({"phase": "moonlight_generate", **row})
    want = counts_with(amp_stage_mma=2, moe_experts=4 * 26,
                       alias_free_act=k5_launches(mods.vocoder, dtype, True, 2 * latent),
                       wide_conv=k6_launches(mods.vocoder, dtype, True, 2 * latent))
    if not (list(hows.values()) == ["captured"] and row["counts_per_replay"] == want
            and row["counts_eager"] == want and row["replay_vs_eager_max_abs"] <= REPLAY_TOL
            and bool(torch.isfinite(wav_r).all())):
        raise AssertionError(f"moonlight_generate: {row}")
    pipe._graphs.clear()
    return row


def moe_row(kernel_rows: list, gen_row: dict) -> dict:
    """The kernels line's K7 entry: launches per Moonlight generate, errors
    against the plain loop, and the ms of the cell's call (128 tokens under
    its uneven routing) beside its bound and the plain loop's."""
    nm = "not measured"
    cell = next((r for r in kernel_rows if r["tokens"] == 128 and r["skew"] == MOE_SKEW), {})
    return {"name": "moe_experts", "route": "triton",
            "source": "audiolcm_torch/nn/moe_experts.py",
            "units": "tensor cores (Triton tl.dot bf16, f32 sums)",
            "replaces": "no Pallas kernel: the JAX package has no expert layer",
            "launches": gen_row.get("counts_per_replay", {}).get("moe_experts", nm),
            "bf16_mean_err_ratio_max": max((r["bf16_mean_err"] / r["plain_bf16_mean_err"]
                                            for r in kernel_rows if "bf16_mean_err" in r),
                                           default=nm),
            **{key: cell.get(key, nm) for key in ("ms", "device_ms", "bound_ms", "bound_by",
                                                  "plain_ms")},
            "library_ms": None,
            "library_note": "no single PyTorch call computes a grouped expert SwiGLU",
            "per_case": kernel_rows}


def kernels_line(checks, k2_checks, flash_checks, times, k2_times, flash_time, gen_row,
                 teacher_row, act_checks, act_times, interior, build_row, act_forms,
                 wide_forms) -> dict:
    """One entry per kernel: launches on its path (K1: the LCM generate,
    every one on its tensor-core kernel, launches_mma; K3: the teacher
    generate; K4: the profiler run; K5: the LCM generate; K2a/K2b lie on
    none), the largest f32 error of its checks, and this run's times (K1/K2:
    both fused stages of one batch-8 generate, summed; K3: one launch at the
    teacher's shape; K4: its four profiler launches, n_rep 2 and 6 at both
    shapes, summed; K5: the 73 launches of one batch-8 generate, 18 per
    unfused stage and one for activation_post, from the act_forms rows; K6:
    the 72 launches of one batch-8 generate, from the wide_conv_forms rows,
    against cuDNN's same convs as its library_ms)."""
    measured = bool(times)
    nm = "not measured"
    b8 = sorted((s for s in times if s[0] == 8), reverse=True)  # (batch, C, T)
    k1_sum = lambda key: sum(times[s][key] for s in b8) if measured else nm
    widest = max(times.values(), key=lambda r: r["bound_ms"]) if measured else {}
    ratio = lambda rows: max(r["bf16_mean_err"] / r["plain_bf16_mean_err"] for r in rows)
    region_ratio = lambda rows: max(k / p for r in rows for k, p in r["bf16_region_mean_err"].values())
    common = {"route": "cuda", "source": "audiolcm_torch/csrc/amp_stage.cu",
              "units": "bf16: tensor cores (amp_stage_mma_kernel, wgmma m64nNk16 bf16, "
                       "f32 sums) and CUDA cores (its activations); f32: CUDA cores "
                       "(amp_stage_kernel)",
              "plain_ms": k1_sum("plain_ms"), "bound_ms": k1_sum("bound_ms"),
              "act_f32_bound_ms": k1_sum("act_f32_bound_ms"),
              "bound_by": widest.get("bound_by", nm), "library_ms": None,
              "library_note": "no single PyTorch call computes a fused AMP stage",
              "sass_hgmma": build_row.get("amp_stage_sass_hgmma", nm)}
    out = [{"name": "amp_stage",
            "replaces": "audiolcm_tpu/nn/pallas_amp_stage.py:665 fused_amp_stage_cl_batched",
            "launches": gen_row["launches"]["amp_stage.mma"]
            + gen_row["launches"]["amp_stage.f32"],
            "launches_mma": gen_row["launches"]["amp_stage.mma"],
            "max_abs_err": max(r["f32_max_abs_err"] for r in checks),
            "bf16_mean_err_ratio_max": ratio(checks),
            "bf16_region_err_ratio_max": region_ratio(checks),
            "ms": k1_sum("ms"), "device_ms": k1_sum("device_ms"), **common,
            "per_shape": list(times.values())}]
    for name, site in (("amp_stage_tc", "audiolcm_tpu/nn/pallas_amp_stage.py:477 fused_amp_stage"),
                       ("amp_stage_cl",
                        "audiolcm_tpu/nn/pallas_amp_stage.py:566 fused_amp_stage_cl")):
        out.append({"name": name, "replaces": site,
                    "max_abs_err": max(r["f32_max_abs_err"] for r in k2_checks
                                       if r["kernel"] == name),
                    "bf16_mean_err_ratio_max": ratio([r for r in k2_checks
                                                      if r["kernel"] == name]),
                    "bf16_region_err_ratio_max": region_ratio([r for r in k2_checks
                                                               if r["kernel"] == name]),
                    "ms": sum(k2_times[(name, *s[1:])] for s in b8) if measured else nm,
                    **common})
    hmma = build_row.get("flash_attention_sass_hmma")
    out.append({"name": "flash_attention", "route": "cuda",
                "units": "tensor cores (mma.sync m16n8k16 bf16, f32 sums) for bf16; "
                         "CUDA cores for f32",
                "source": "audiolcm_torch/csrc/flash_attention.cu",
                "replaces": "audiolcm_tpu/nn/pallas_attention.py:72 flash_attention",
                "launches": teacher_row["launches"]["flash_attention.tc"]
                + teacher_row["launches"]["flash_attention.f32"],
                "launches_tc": teacher_row["launches"]["flash_attention.tc"],
                "max_abs_err": max(r["f32_max_abs_err"] for r in flash_checks),
                "bf16_max_abs_err_vs_plain_bf16": max(r["bf16_max_abs_err_vs_plain_bf16"]
                                                      for r in flash_checks),
                "bf16_mean_err_ratio_max": max(r["bf16_mean_err"] / r["plain_bf16_mean_err"]
                                               for r in flash_checks),
                "sass_hmma": hmma if hmma is not None else nm,
                **{k: flash_time.get(k, nm) for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                      "library_ms")},
                "shape": flash_time.get("shape", nm),
                "launches_plms_25": teacher_row["plms"]["launches"]["flash_attention.tc"],
                "launches_lcm_with_flash": gen_row["launches_with_flash"]["flash_attention.tc"]})
    act_sum = lambda key: sum(r[key] for r in act_times) if act_times else nm
    out.append({"name": "act_chain", "route": "cuda", "source": "audiolcm_torch/csrc/act_chain.cu",
                "replaces": "tools/profile_stage_interior.py:110 act_only_fn",
                "launches": interior["launches"]["act_chain"],
                "max_abs_err": max(r["f32_max_abs_err"] for r in act_checks),
                "ms": act_sum("ms"), "plain_ms": act_sum("plain_ms"),
                "bound_ms": act_sum("bound_ms"), "f32_bound_ms": act_sum("f32_bound_ms"),
                "bound_by": act_times[0]["bound_by"] if act_times else nm, "library_ms": None,
                "library_note": "no single PyTorch call computes a chain of alias-free SnakeBetas",
                "per_case": act_times})
    b8 = [r for r in act_forms if r["batch"] == 8]
    per_request = lambda key: (sum(18 * r[key] for r in b8 if r["C"] >= 96)  # noqa: E731
                               + sum(r[key] for r in b8 if r["C"] == 24)) if b8 else nm
    out.append({"name": "alias_free_act", "route": "cuda",
                "source": "audiolcm_torch/csrc/alias_free_act.cu",
                "replaces": "no Pallas kernel: the jnp chain audiolcm_tpu/nn/resample.py:212 "
                            "alias_free_activation",
                "launches": gen_row["launches"]["alias_free_act"],
                "max_abs_err": max((r["f32_max_abs_err"] for r in act_forms), default=nm),
                "bf16_mean_err_ratio_max": max((r["bf16_mean_err"] / r["depthwise_bf16_mean_err"]
                                                for r in act_forms), default=nm),
                "ms": per_request("kernel_ms"), "device_ms": per_request("kernel_device_ms"),
                "plain_ms": per_request("polyphase_ms"),
                "depthwise_ms": per_request("depthwise_ms"), "bound_ms": per_request("bound_ms"),
                "f32_bound_ms": per_request("f32_bound_ms"), "library_ms": None,
                "library_note": "no single PyTorch call computes an alias-free SnakeBeta",
                "per_case": act_forms})
    w8 = [r for r in wide_forms if r["batch"] == 8]
    w_sum = lambda key: sum(r[key] for r in w8) if w8 else nm  # noqa: E731
    out.append({"name": "wide_conv", "route": "cuda",
                "source": "audiolcm_torch/csrc/wide_conv.cu",
                "units": "tensor cores (wgmma m64nNk16 bf16, A from registers, f32 sums)",
                "replaces": "no Pallas kernel: XLA's convs in audiolcm_tpu/models/bigvgan.py",
                "launches": gen_row["launches"]["wide_conv"],
                "bf16_mean_err_ratio_max": max((e["k6_mean_err"] / e["cudnn_mean_err"]
                                                for r in wide_forms
                                                for e in r["errors"].values()), default=nm),
                "ms": w_sum("k6_ms"), "device_ms": w_sum("k6_device_ms"),
                "bound_ms": w_sum("bound_ms"), "bound_by": "operations",
                "plain_ms": None, "library_ms": w_sum("cudnn_ms"),
                "library_note": "the 72 convs of a b8 request through cuDNN, with the bf16 sums",
                "sass_hgmma": build_row.get("wide_conv_sass_hgmma", nm),
                "per_case": wide_forms})
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny widths on the CPU with the plain versions; prints no device line")
    args = ap.parse_args(argv)
    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import audiolcm_torch  # noqa: F401  (fails outside a checkout of the repository)

    device = torch.device("cpu" if rehearsal else "cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    marks = [("start", time.time())]
    mark = lambda name: marks.append((name, time.time()))
    card = card_phase(device)
    emit({"phase": "card", **card})
    track_k5_due()
    build_row = {}
    if not rehearsal:
        build_row = build_phase()
        emit({"phase": "build", **build_row})
    mark("card+build")
    shapes = [(48, 79872), (24, 159744), (48, 79872 - 77)] if not rehearsal else [(6, 700)]
    # K1 at batch 2 and at every shape time_phase times (batch 8 of 10 s
    # clips, batch 1 of a 20 s clip), each at its own tile, and batch 8 and 1
    # at a T that is no multiple of the tile
    time_cases = [(8, 48, 79872), (8, 24, 159744), (1, 48, 159744), (1, 24, 319488)]
    check_cases = ([(2, c, t) for c, t in shapes] + time_cases
                   + [(8, 48, 79872 - 77), (1, 24, 319488 - 77)]
                   if not rehearsal else [(2, 6, 700), (8, 6, 700), (1, 6, 1400 - 77)])
    checks = check_phase(device, check_cases, rehearsal)
    checks += check_variants_phase(device, shapes, rehearsal)
    k2_checks = check_k2_phase(device, shapes[:2], rehearsal)
    # the teacher's DiT attention (CFG batch 16, T = 467), the longest DiT
    # sequence (max_len 1000), a short head, the chunk views of to_qkv, a
    # head (D = 33) that only the element-wise loads take, the widest
    # heads the kernel takes (D = 64, 128); the Flag teacher's
    # self-attention (CFG batch 16, 32 heads, T = 312) and its caption
    # branch (312 queries over 154 keys)
    flash_cases = ([((16, 8, 467, 72), False, "tc_vec"), ((2, 8, 1000, 72), False, "tc_vec"),
                    ((1, 2, 100, 8), False, "tc_vec"), ((16, 8, 467, 72), True, "tc_vec"),
                    ((2, 3, 5, 33), False, "tc_elementwise"), ((2, 4, 300, 64), False, "tc_vec"),
                    ((2, 2, 200, 128), False, "tc_vec"), FLAG_SELF, FLAG_CROSS]
                   if not rehearsal else [((2, 2, 37, 8), False, "tc_vec"),
                                          ((2, 2, 37, 8), True, "tc_vec"),
                                          ((2, 3, 5, 33), False, "tc_elementwise"),
                                          ((2, 2, 37, 8), False, "tc_vec", 19)])
    flash_checks = check_flash_phase(device, flash_cases)
    act_checks = check_act_phase(device, shapes, rehearsal)
    mark("check")
    times, k2_times, flash_time, act_times, act_forms, wide_forms = {}, {}, {}, [], [], []
    flag_flash_times = []
    if not rehearsal:
        times = time_phase(device, time_cases, card)
        k2_times = time_k2_phase(device, shapes[:2], card)
        flash_time = time_flash_phase(device, (16, 8, 467, 72), card)
        flag_flash_times = [time_flash_phase(device, FLAG_SELF[0], card),
                            time_flash_phase(device, FLAG_CROSS[0], card, tk=FLAG_CROSS[3])]
        act_times = time_act_phase(device, shapes[:2], card)
        act_forms = act_forms_phase(device, card)
        wide_forms = wide_conv_forms_phase(device, card)
    moe_kernels = moe_kernel_phase(device, rehearsal, card)
    mark("time")
    mods = build_modules(device, full=not rehearsal)
    gen_row = generate_phase(device, mods, full=not rehearsal, card=card)
    knob_phase(device, mods, full=not rehearsal)
    mark("generate+knob")
    with tempfile.TemporaryDirectory() as tmp:
        native_ckpt_phase(device, mods, full=not rehearsal, card=card, tmp=tmp)
    mark("native_ckpt")
    teacher_check_phase(device, full=not rehearsal)
    teacher_row = teacher_phase(device, mods, full=not rehearsal, card=card)
    flag_row = flag_teacher_phase(device, mods, full=not rehearsal, card=card)
    mark("teacher")
    prewarm_row = prewarm_phase(device, mods, full=not rehearsal, card=card)
    mark("prewarm")
    train_phase(device, mods, full=not rehearsal, card=card, kind="distill")
    train_phase(device, mods, full=not rehearsal, card=card, kind="teacher_train")
    mark("distill+teacher_train")
    ddp_phase(device, mods, full=not rehearsal, card=card)
    mark("ddp")
    fsdp_phase(device, mods, full=not rehearsal, card=card)
    mark("fsdp")
    del mods
    budget_row = error_budget_phase(device, full=not rehearsal, card=card)
    mark("error_budget")
    interior = interior_phase(device, shapes[:2], card, rehearsal)
    mark("interior")
    with tempfile.TemporaryDirectory() as tmp:
        vocode_phase(device, full=not rehearsal, card=card, tmp=tmp)
    roundtrip_phase(device, full=not rehearsal, card=card)
    mark("vocode+roundtrip")
    train_vae_phase(device, full=not rehearsal, card=card)
    mark("train_vae")
    train_cli_phase(device, full=not rehearsal, card=card)
    mark("train_cli")
    train_vocoder_phase(device, full=not rehearsal, card=card)
    mark("train_vocoder")
    train_vae_variants_phase(device, full=not rehearsal, card=card)
    train_vae_variants_cli_phase(device, full=not rehearsal, card=card)
    mark("train_vae_variants")
    eval_phase(device, full=not rehearsal, card=card)
    eval_cli_phase(device, full=not rehearsal, card=card)
    mark("eval")
    variant_models_phase(device, full=not rehearsal, card=card)
    mark("variant_models")
    ldm_variants_phase(device, full=not rehearsal, card=card)
    mark("ldm_variants")
    open_clap_phase(device, full=not rehearsal, card=card)
    mark("open_clap")
    train_micro_phase(device, full=not rehearsal, card=card)
    mark("train_micro")
    moon_row = moonlight_generate_phase(device, full=not rehearsal, card=card)
    mark("moonlight_generate")
    emit({"phase": "seconds", "total": marks[-1][1] - marks[0][1],
          "by_phase": {n: t - marks[i][1] for i, (n, t) in enumerate(marks[1:])}})
    line = kernels_line(checks, k2_checks, flash_checks, times, k2_times, flash_time, gen_row,
                        teacher_row, act_checks, act_times, interior, build_row, act_forms,
                        wide_forms)
    k3 = next(k for k in line["kernels"] if k["name"] == "flash_attention")
    k3.update(launches_flag_teacher=flag_row["launches"]["flash_attention.tc"],
              launches_flag_teacher_cross=flag_row["launches"]["flash_attention.cross"],
              flag_per_shape=flag_flash_times or "not measured")
    line["kernels"][0]["launches_per_captured_replay"] = prewarm_row.get(
        "k1_launches_per_replay", "not measured")
    for k, keys in ((line["kernels"][0], ("amp_stage.f32", "amp_stage.mma")),
                    (k3, ("flash_attention.f32", "flash_attention.tc"))):
        k["launches_error_budget"] = {name: {c: r["launches"][c] for c in keys}
                                      for name, r in budget_row["rows"].items()}
    line["kernels"].append(moe_row(moe_kernels, moon_row))
    emit(line)
    if rehearsal:
        emit({"rehearsal": True, "ok": True})
        return 0
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
