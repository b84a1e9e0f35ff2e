"""Fused BigVGAN AMP stage: the CUDA kernel K1 (`csrc/amp_stage.cu`), its
plain PyTorch version, and the per-tile math the kernel implements.

One stage = `len(kernel_sizes)` resblocks, each `len(dilations)` sub-units
of (alias-free SnakeBeta -> dilated conv -> alias-free SnakeBeta -> conv)
plus the residual; the output is the mean of the resblocks. It replaces the
TPU kernel `audiolcm_tpu/nn/pallas_amp_stage.py:fused_amp_stage_cl_batched`.

  * `fused_amp_stage` — the wrapper. A CUDA tensor launches the kernel (or
    raises); a CPU tensor runs `fused_amp_stage_plain`.
  * `fused_amp_stage_tc` / `fused_amp_stage_cl` — the same function with
    the launch structure of the TPU kernels `fused_amp_stage` (K2a) and
    `fused_amp_stage_cl` (K2b): one launch of the same CUDA kernel per batch
    element.
  * `fused_amp_stage_plain` — the same stage in plain torch ops with the
    unfused path's edge rules (`resample_cf.alias_free_snake_cf`,
    `conv1d_cf`). Used by the CPU tests and by chip_smoke's comparison.
  * `stage_valid_cl` / `valid_alias_free_snake_cl` — the padding-free
    ("valid") stage math on one (C, L) window, as the JAX package defines it.
  * `stage_tiles_emulated` — the kernel's own algorithm (tile + halo, each
    op shrinking its valid range, edges in global coordinates) in torch, so
    the CPU tests hold the kernel's decomposition against the JAX package.

stage_params[b]["sub"][s] = {a1, b1, w1, c1b, a2, b2, w2, c2b}: snake
alpha/beta already exponentiated (linear scale), conv weights in the torch
layout (C_out, C_in, k).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch
import torch.nn.functional as F

from audiolcm_torch.nn.resample import correlate, alias_free_taps
from audiolcm_torch.nn.resample_cf import alias_free_snake_cf, conv1d_cf
from audiolcm_torch.nn.snake import snake_binv

# Kernel launches since the last reset (chip_smoke sets them to 0 around a
# run): by fused_amp_stage (K1), fused_amp_stage_tc (K2a), fused_amp_stage_cl (K2b).
LAUNCHES = 0
LAUNCHES_TC = 0
LAUNCHES_CL = 0

R_ACT = 6  # receptive radius of the alias-free activation
SMEM_BYTES = 232448  # H100: shared memory one block can use
EO_GROUP = 8  # must match csrc/amp_stage.cu
ACCUM_MODES = ("bf16", "f32")
CONV_MODES = ("tap", "mstack", "kstack")


def subblock_radius(k: int, dilation: int) -> int:
    return R_ACT + (k - 1) * dilation // 2 + R_ACT + (k - 1) // 2


def stage_radius(kernel_sizes: Sequence[int], dilations: Sequence[int]) -> int:
    """Max receptive radius over the parallel resblocks (96 for the shipped
    (3, 7, 11) x (1, 3, 5))."""
    return max(sum(subblock_radius(k, d) for d in dilations) for k in kernel_sizes)


def smem_bytes(c: int, tile: int, r: int) -> int:
    n = tile + 2 * r
    return 4 * (3 * c * n + c * tile + 2 * EO_GROUP * n)


def pick_tile(c: int, r: int, max_tile: int = 512) -> int:
    """Largest multiple of 32 (<= max_tile) whose shared-memory footprint
    fits one block: 128 at C=48 and 352 at C=24 for r=96."""
    for tile in range(max_tile, 31, -32):
        if smem_bytes(c, tile, r) <= SMEM_BYTES:
            return tile
    raise ValueError(f"fused AMP stage: C={c} does not fit shared memory at radius {r}")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def fused_amp_stage_plain(x: torch.Tensor, stage_params: List[dict],
                          kernel_sizes: Sequence[int], dilations: Sequence[int],
                          fast: bool = False) -> torch.Tensor:
    """(B, T, C) -> (B, T, C): the unfused stage in plain torch ops."""
    h = x.transpose(1, 2)
    acc = None
    for bi in range(len(kernel_sizes)):
        h_res = h
        for si, d in enumerate(dilations):
            p = stage_params[bi]["sub"][si]
            y = alias_free_snake_cf(h_res, p["a1"], p["b1"], fast)
            y = conv1d_cf(y, p["w1"], p["c1b"], d)
            y = alias_free_snake_cf(y, p["a2"], p["b2"], fast)
            y = conv1d_cf(y, p["w2"], p["c2b"], 1)
            h_res = h_res + y
        acc = h_res if acc is None else acc + h_res
    return (acc / len(kernel_sizes)).transpose(1, 2)


# ---------------------------------------------------------------------------
# valid (padding-free) per-window math, (C, L) layout
# ---------------------------------------------------------------------------


def valid_alias_free_snake_cl(x: torch.Tensor, alpha, beta, fast: bool = False) -> torch.Tensor:
    """(C, L) -> (C, L - 2*R_ACT); out[t] equals the padded op at t + R_ACT
    away from the sequence edges."""
    up_e, up_o, dn_e, dn_o = alias_free_taps()
    l = x.shape[-1]
    ue = correlate(x, up_e, l - 6, -1)
    uo = correlate(x[..., 1:], up_o, l - 6, -1)
    a, binv = alpha[:, None], (1.0 / (beta + 1e-9))[:, None]
    ae, ao = snake_binv(ue, a, binv, fast), snake_binv(uo, a, binv, fast)
    n = l - 2 * R_ACT
    return correlate(ao, dn_e, n, -1) + correlate(ae[..., 1:], dn_o, n, -1)


def valid_conv_cl(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  dilation: int) -> torch.Tensor:
    """(C_in, L) x w (C_out, C_in, k) -> (C_out, L - (k-1)*d), f32 sums."""
    y = F.conv1d(x[None].float(), w.float(), bias.float(), dilation=dilation)[0]
    return y.to(x.dtype)


def _center(x: torch.Tensor, out_len: int) -> torch.Tensor:
    off = (x.shape[-1] - out_len) // 2
    return x[..., off:off + out_len]


def stage_valid_cl(x: torch.Tensor, stage_params: List[dict], kernel_sizes: Sequence[int],
                   dilations: Sequence[int], fast: bool = False) -> torch.Tensor:
    """(C, L) -> (C, L - 2*R): the whole stage with valid semantics."""
    out_len = x.shape[-1] - 2 * stage_radius(kernel_sizes, dilations)
    acc = None
    for bi in range(len(kernel_sizes)):
        h_res = x
        for si, d in enumerate(dilations):
            p = stage_params[bi]["sub"][si]
            h = valid_alias_free_snake_cl(h_res, p["a1"], p["b1"], fast)
            h = valid_conv_cl(h, p["w1"], p["c1b"], d)
            h = valid_alias_free_snake_cl(h, p["a2"], p["b2"], fast)
            h = valid_conv_cl(h, p["w2"], p["c2b"], 1)
            h_res = _center(h_res, h.shape[-1]) + h
        contrib = _center(h_res, out_len)
        acc = contrib if acc is None else acc + contrib
    return acc / len(kernel_sizes)


# ---------------------------------------------------------------------------
# the kernel's algorithm, in torch
# ---------------------------------------------------------------------------


def stage_tiles_emulated(x: torch.Tensor, stage_params: List[dict],
                         kernel_sizes: Sequence[int], dilations: Sequence[int],
                         fast: bool = False, tile: int | None = None) -> torch.Tensor:
    """(B, T, C) -> (B, T, C) computed as csrc/amp_stage.cu does: f32 inside,
    one window of tile + 2R samples per tile, every op over its shrinking
    valid range, edge rules applied in global coordinates (conv inputs zero
    outside [0, T); the activation's FIRs read their inputs clamped to the
    first/last sample). The output is rounded to x's dtype once."""
    up_e, up_o, dn_e, dn_o = alias_free_taps()
    b, t, c = x.shape
    r = stage_radius(kernel_sizes, dilations)
    tile = tile or pick_tile(c, r)
    n = tile + 2 * r
    xc = x.transpose(1, 2).float()
    sp = [{"sub": [{k: v.float() for k, v in s.items()} for s in blk["sub"]]}
          for blk in stage_params]
    out = torch.empty_like(xc)
    for t0 in range(0, t, tile):
        base = t0 - r
        g = torch.arange(base, base + n)
        inside = (g >= 0) & (g < t)

        def act(inp, lo, hi, alpha, beta):
            # snaked up-phases over [lo-3, hi+3), clamped global reads
            ge = g[lo - 3:hi + 3]

            def up(taps, shift, pos):
                idx = (pos[:, None] + torch.arange(6) - shift).clamp(0, t - 1) - base
                return _corr_idx(inp, idx, taps)

            a = alpha[:, None]
            binv = (1.0 / (beta + 1e-9))[:, None]
            snk = lambda u: snake_binv(u, a, binv, fast)
            ae = snk(up(up_e, 3, ge.clamp(0, t - 1)))
            ao = snk(up(up_o, 2, ge.clamp(0, t - 1)))
            e, o = ae, ao
            if ge[0] < 0:  # u[0] = ae[0]; the window holds position 0
                left = snk(up(up_e, 3, torch.tensor([0])))
                e, o = torch.where(ge < 0, left, e), torch.where(ge < 0, left, o)
            if ge[-1] >= t:  # u[2T-1] = ao[T-1]; the window holds T-1
                right = snk(up(up_o, 2, torch.tensor([t - 1])))
                e, o = torch.where(ge >= t, right, e), torch.where(ge >= t, right, o)
            y = correlate(o, dn_e, hi - lo, -1) + correlate(e[..., 1:], dn_o, hi - lo, -1)
            res = torch.zeros_like(inp)
            res[..., lo:hi] = torch.where(inside[lo:hi], y, 0.0)
            return res

        def conv(inp, lo, hi, w, bias, d):
            half = (w.shape[-1] - 1) // 2 * d
            res = torch.zeros_like(inp)
            res[..., lo:hi] = F.conv1d(inp[..., lo - half:hi + half], w, bias, dilation=d)
            return res

        window = torch.zeros(b, c, n)
        window[..., inside] = xc[..., g[inside]]
        acc = None
        for bi, k in enumerate(kernel_sizes):
            rk = sum(subblock_radius(k, d) for d in dilations)
            lo, hi = r - rk, n - (r - rk)
            res = window.clone()
            for si, d in enumerate(dilations):
                p = sp[bi]["sub"][si]
                h = act(res, lo + 6, hi - 6, p["a1"], p["b1"])
                lo, hi = lo + 6, hi - 6
                h1 = (k - 1) // 2 * d
                h = conv(h, lo + h1, hi - h1, p["w1"], p["c1b"], d)
                lo, hi = lo + h1, hi - h1
                h = act(h, lo + 6, hi - 6, p["a2"], p["b2"])
                lo, hi = lo + 6, hi - 6
                h2 = (k - 1) // 2
                res = res + conv(h, lo + h2, hi - h2, p["w2"], p["c2b"], 1)
                lo, hi = lo + h2, hi - h2
            centre = res[..., r:r + tile]
            acc = centre if acc is None else acc + centre
        end = min(t0 + tile, t)
        out[..., t0:end] = (acc / len(kernel_sizes))[..., :end - t0]
    return out.to(x.dtype).transpose(1, 2)


def _corr_idx(inp: torch.Tensor, idx: torch.Tensor, taps) -> torch.Tensor:
    """sum_d taps[d] * inp[..., idx[:, d]] (sequential sum over d)."""
    acc = None
    for d, w in enumerate(taps):
        term = w * inp[..., idx[:, d]]
        acc = term if acc is None else acc + term
    return acc


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library():
    from audiolcm_torch.build import build

    lib = ctypes.CDLL(str(build("amp_stage")))
    lib.amp_stage_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_void_p])
    lib.amp_stage_launch.restype = ctypes.c_int
    return lib


def check_stage_params(stage_params: List[dict], kernel_sizes: Sequence[int],
                       dilations: Sequence[int], c: int) -> None:
    """Raise unless stage_params has one block per kernel size, one sub-unit
    per dilation, (C, C, k) weights and (C,) vectors: the kernel reads them
    through raw pointers at those sizes."""
    if len(stage_params) != len(kernel_sizes):
        raise ValueError(f"{len(stage_params)} resblocks of params for kernel sizes {kernel_sizes}")
    for blk, k in zip(stage_params, kernel_sizes):
        if len(blk["sub"]) != len(dilations):
            raise ValueError(f"{len(blk['sub'])} sub-units of params for dilations {dilations}")
        for p in blk["sub"]:
            for name, want in (("w1", (c, c, k)), ("w2", (c, c, k)), ("a1", (c,)), ("b1", (c,)),
                               ("c1b", (c,)), ("a2", (c,)), ("b2", (c,)), ("c2b", (c,))):
                if tuple(p[name].shape) != want:
                    raise ValueError(f"stage param {name} has shape {tuple(p[name].shape)}, "
                                     f"expected {want}")


def pack_stage_params(stage_params: List[dict], device) -> tuple:
    """(weights, vectors) as the kernel reads them, f32 on `device`."""
    ws, vecs = [], []
    for blk in stage_params:
        for p in blk["sub"]:
            ws += [p["w1"].float().reshape(-1), p["w2"].float().reshape(-1)]
            b1, b2 = p["b1"].float(), p["b2"].float()
            vecs += [p["a1"].float(), 1.0 / (b1 + 1e-9), p["c1b"].float(),
                     p["a2"].float(), 1.0 / (b2 + 1e-9), p["c2b"].float()]
    return torch.cat(ws).to(device), torch.cat(vecs).to(device)


def _launch_cf(xc: torch.Tensor, out: torch.Tensor, packed: tuple, kernel_sizes, dilations,
               fast) -> None:
    """One kernel launch over channels-first contiguous xc (B, C, T) into
    out; packed = pack_stage_params(...)."""
    if xc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused AMP stage kernel takes float32 or bfloat16, not {xc.dtype}")
    b, c, t = xc.shape
    r = stage_radius(kernel_sizes, dilations)
    w, vec = packed
    ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
    ds = (ctypes.c_int * len(dilations))(*dilations)
    taps = (ctypes.c_float * 24)(*[v for group in alias_free_taps() for v in group])
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        rc = _library().amp_stage_launch(
            xc.data_ptr(), out.data_ptr(), w.data_ptr(), vec.data_ptr(), b, c, t,
            pick_tile(c, r), r, len(kernel_sizes), len(dilations), ks, ds, int(fast),
            int(xc.dtype == torch.bfloat16), taps, stream)
    if rc != 0:
        raise RuntimeError(f"amp_stage kernel launch failed: CUDA error {rc}")


def _check_stage(x: torch.Tensor, stage_params, kernel_sizes, dilations, accum: str) -> None:
    if accum not in ACCUM_MODES:
        raise ValueError(f"accum must be one of {ACCUM_MODES}, got {accum!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x.shape)}")
    if any(k % 2 == 0 for k in kernel_sizes):
        raise ValueError(f"kernel sizes must be odd, got {tuple(kernel_sizes)}")
    if not (1 <= len(kernel_sizes) <= 4 and 1 <= len(dilations) <= 4):
        raise ValueError("the kernel takes 1-4 resblocks of 1-4 sub-units")
    pick_tile(x.shape[-1], stage_radius(kernel_sizes, dilations))  # raises if C too wide
    check_stage_params(stage_params, kernel_sizes, dilations, x.shape[-1])
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused AMP stage runs on cuda or cpu, not {x.device}")


def fused_amp_stage(x: torch.Tensor, stage_params: List[dict],
                    kernel_sizes: Sequence[int] = (3, 7, 11),
                    dilations: Sequence[int] = (1, 3, 5), fast: bool = False,
                    accum: str = "bf16", conv: str = "tap") -> torch.Tensor:
    """(B, T, C) -> (B, T, C): one fused AMP stage, equal to the unfused
    stage everywhere including the first and last samples.

    On a CUDA tensor this launches the sm_90a kernel once for the whole
    batch or raises; on a CPU tensor it runs the plain version. `accum` and
    `conv` are the JAX knobs, accepted and validated: the kernel keeps every
    intermediate and sum in f32 (error at or below the JAX "bf16" and "f32"
    modes), and one formulation serves all three `conv` values, which the
    JAX package measured to give the same numbers."""
    global LAUNCHES
    if conv not in CONV_MODES:
        raise ValueError(f"conv must be one of {CONV_MODES}, got {conv!r}")
    _check_stage(x, stage_params, kernel_sizes, dilations, accum)
    if x.device.type == "cpu":
        return fused_amp_stage_plain(x, stage_params, kernel_sizes, dilations, fast)
    xc = x.transpose(1, 2).contiguous()
    out = torch.empty_like(xc)
    _launch_cf(xc, out, pack_stage_params(stage_params, x.device), kernel_sizes, dilations, fast)
    LAUNCHES += 1
    return out.transpose(1, 2)


def fused_amp_stage_tc(x: torch.Tensor, stage_params: List[dict],
                       kernel_sizes: Sequence[int] = (3, 7, 11),
                       dilations: Sequence[int] = (1, 3, 5), fast: bool = False,
                       accum: str = "bf16") -> torch.Tensor:
    """K2a, `audiolcm_tpu/nn/pallas_amp_stage.py:fused_amp_stage`: the same
    stage with the TPU kernel's launch structure, one launch per batch
    element, each on that element's own (T, C) -> (C, T) transpose. The
    JAX `reference_fn` and `tile` are not taken: the kernel computes the
    edges itself and masks a ragged last tile. CPU: the plain version."""
    global LAUNCHES_TC
    _check_stage(x, stage_params, kernel_sizes, dilations, accum)
    if x.device.type == "cpu":
        return fused_amp_stage_plain(x, stage_params, kernel_sizes, dilations, fast)
    packed, outs = pack_stage_params(stage_params, x.device), []
    for i in range(x.shape[0]):
        xc = x[i:i + 1].transpose(1, 2).contiguous()
        out = torch.empty_like(xc)
        _launch_cf(xc, out, packed, kernel_sizes, dilations, fast)
        LAUNCHES_TC += 1
        outs.append(out.transpose(1, 2))
    return torch.cat(outs)


def fused_amp_stage_cl(x: torch.Tensor, stage_params: List[dict],
                       kernel_sizes: Sequence[int] = (3, 7, 11),
                       dilations: Sequence[int] = (1, 3, 5), fast: bool = False,
                       accum: str = "bf16", conv: str = "tap") -> torch.Tensor:
    """K2b, `audiolcm_tpu/nn/pallas_amp_stage.py:fused_amp_stage_cl`: the
    channels-first form, one (B, T, C) -> (B, C, T) transpose for the batch
    and then one launch per batch element on its (C, T) slice. conv="kstack"
    is refused, as the JAX function refuses it. CPU: the plain version."""
    global LAUNCHES_CL
    if conv not in ("tap", "mstack"):
        raise ValueError(f"fused_amp_stage_cl takes conv 'tap' or 'mstack', got {conv!r}")
    _check_stage(x, stage_params, kernel_sizes, dilations, accum)
    if x.device.type == "cpu":
        return fused_amp_stage_plain(x, stage_params, kernel_sizes, dilations, fast)
    xc = x.transpose(1, 2).contiguous()
    out = torch.empty_like(xc)
    packed = pack_stage_params(stage_params, x.device)
    for i in range(x.shape[0]):
        _launch_cf(xc[i:i + 1], out[i:i + 1], packed, kernel_sizes, dilations, fast)
        LAUNCHES_CL += 1
    return out.transpose(1, 2)
