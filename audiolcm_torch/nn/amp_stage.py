"""Fused BigVGAN AMP stage: the CUDA kernels of K1 (`csrc/amp_stage.cu`),
their plain PyTorch version, and the per-tile math the kernels implement.

One stage = `len(kernel_sizes)` resblocks, each `len(dilations)` sub-units
of (alias-free SnakeBeta -> dilated conv -> alias-free SnakeBeta -> conv)
plus the residual; the output is the mean of the resblocks. It replaces the
TPU kernel `audiolcm_tpu/nn/pallas_amp_stage.py:fused_amp_stage_cl_batched`.

  * `fused_amp_stage` — the wrapper. A CUDA tensor launches a kernel (or
    raises): bf16 goes to the tensor-core kernel ("mma": bf16 conv operands,
    f32 sums and residual), f32 to the CUDA-core kernel ("cuda_core": f32
    throughout), as `pick_route` says; a CPU tensor runs
    `fused_amp_stage_plain`.
  * `fused_amp_stage_tc` / `fused_amp_stage_cl` — the same function with
    the launch structure of the TPU kernels `fused_amp_stage` (K2a) and
    `fused_amp_stage_cl` (K2b): one launch of the same CUDA kernels per
    batch element.
  * `fused_amp_stage_plain` — the same stage in plain torch ops with the
    unfused path's edge rules (`resample_cf.alias_free_snake_cf`,
    `conv1d_cf`). Used by the CPU tests and by chip_smoke's comparison.
  * `stage_valid_cl` / `valid_alias_free_snake_cl` — the padding-free
    ("valid") stage math on one (C, L) window, as the JAX package defines it.
  * `stage_tiles_emulated` — the kernels' own algorithm (tile + halo, each
    op shrinking its valid range, edges in global coordinates, and each
    route's rounding points) in torch, so the CPU tests hold the kernels'
    decomposition against the JAX package.
  * `pack_stage_params_mma` / `pack_conv_mma` — the tensor-core kernel's
    weights, bf16 pairs in mma fragment order.

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

from audiolcm_torch import obs
from audiolcm_torch.nn.resample import correlate, alias_free_taps
from audiolcm_torch.nn.resample_cf import alias_free_snake_cf, conv1d_cf
from audiolcm_torch.nn.snake import snake_binv

R_ACT = 6  # receptive radius of the alias-free activation
SMEM_BYTES = 232448  # H100: shared memory one block can use
EO_GROUP = 8  # must match csrc/amp_stage.cu
MMA_MAX_C = 64  # the tensor-core kernel's widest C (8 n8 tiles); csrc MMA_MAX_NT
MMA_PAD_ROWS = 16  # csrc PAD_ROWS
MAX_TILE = 512  # the longest tile either kernel runs (reached at narrow C)
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


def pick_tile(c: int, r: int) -> int:
    """The CUDA-core kernel's tile: the largest multiple of 32 (<= MAX_TILE)
    whose shared-memory footprint fits one block: 128 at C=48 and 352 at
    C=24 for r=96."""
    for tile in range(MAX_TILE, 31, -32):
        if smem_bytes(c, tile, r) <= SMEM_BYTES:
            return tile
    raise ValueError(f"fused AMP stage: C={c} does not fit shared memory at radius {r}")


def mma_pitches(c: int, n: int) -> tuple:
    """(NP, HP) of the tensor-core kernel for a window of n samples: the f32
    residual's row pitch NP = n rounded up to 4 mod 8 floats, and the bf16
    channels-last rows' pitch HP, C rounded up to an odd number of 8-channel
    (16-byte) units."""
    ng = -(-c // 8)
    return n + (4 - n) % 8, 8 * (ng if ng % 2 else ng + 1)


def smem_bytes_mma(c: int, tile: int, r: int) -> int:
    """The tensor-core kernel's shared memory: RES (C x NP) and ACC (C x
    tile) f32, the (N, 8) f32 up-phases E and O, and H ((N + pad rows) x HP)
    and G (N x HP) bf16."""
    n = tile + 2 * r
    np_, hp = mma_pitches(c, n)
    return 4 * (c * np_ + c * tile + 2 * EO_GROUP * n) + 2 * hp * (2 * n + MMA_PAD_ROWS)


def pick_tile_mma(c: int, r: int) -> int:
    """The tensor-core kernel's tile: the largest multiple of 16 (<=
    MAX_TILE) whose footprint fits one block: 192 at C=48 and 512 at C=24
    for r=96."""
    if c > MMA_MAX_C:
        raise ValueError(f"fused AMP stage: the tensor-core kernel takes C <= {MMA_MAX_C}, "
                         f"got C={c}")
    for tile in range(MAX_TILE, 15, -16):
        if smem_bytes_mma(c, tile, r) <= SMEM_BYTES:
            return tile
    raise ValueError(f"fused AMP stage: C={c} does not fit shared memory at radius {r}")


def pick_route(x: torch.Tensor) -> str:
    """The kernel that a CUDA tensor of x's dtype launches: "mma" (the
    tensor-core kernel) for bf16, "cuda_core" for f32."""
    return "mma" if x.dtype == torch.bfloat16 else "cuda_core"


def route_tile(route: str, c: int, r: int) -> int:
    return pick_tile_mma(c, r) if route == "mma" else pick_tile(c, r)


def route_takes(dtype: torch.dtype, c: int, r: int) -> bool:
    """Whether the kernel route of `dtype` has a tile for C at radius r
    (bf16: the tensor-core kernel, f32: the CUDA-core kernel; no other
    dtype has a kernel). Never raises, and answers the same on any device,
    so a caller can decide before any launch which stages to fuse."""
    if dtype == torch.bfloat16:
        return c <= MMA_MAX_C and smem_bytes_mma(c, 16, r) <= SMEM_BYTES
    return dtype == torch.float32 and smem_bytes(c, 32, r) <= SMEM_BYTES


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
    """(B, T, C) -> (B, T, C) computed as csrc/amp_stage.cu does: one window
    of tile + 2R samples per tile, every op over its shrinking valid range,
    edge rules applied in global coordinates (conv inputs zero outside
    [0, T); the activation's FIRs read their inputs clamped to the
    first/last sample), the output rounded to x's dtype once.

    The numerics are those of the kernel a CUDA tensor of x's dtype runs
    (`pick_route`), and `tile` defaults to that route's tile. f32 is the
    CUDA-core kernel: f32 inside. bf16 is the tensor-core kernel: each
    conv's input and weights rounded to bf16, f32 sums, the first conv's
    output (G) rounded to bf16, everything else (residual, resblock mean,
    activations) f32."""
    up_e, up_o, dn_e, dn_o = alias_free_taps()
    b, t, c = x.shape
    r = stage_radius(kernel_sizes, dilations)
    route = pick_route(x)
    tile = tile or route_tile(route, c, r)
    n = tile + 2 * r
    rnd = (lambda v: v.bfloat16().float()) if route == "mma" else (lambda v: v)
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
            res[..., lo:hi] = F.conv1d(rnd(inp[..., lo - half:hi + half]), rnd(w), bias,
                                       dilation=d)
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
                h = rnd(conv(h, lo + h1, hi - h1, p["w1"], p["c1b"], d))
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
    args = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    for fn in (lib.amp_stage_launch, lib.amp_stage_mma_launch):
        fn.argtypes = args
        fn.restype = ctypes.c_int
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


def _pack_vectors(stage_params: List[dict]) -> torch.Tensor:
    """Per sub-unit alpha1, 1/(beta1+1e-9), bias1, alpha2, 1/(beta2+1e-9),
    bias2, f32, as both kernels read them."""
    subs = [p for blk in stage_params for p in blk["sub"]]
    col = lambda name: torch.stack([p[name] for p in subs]).float()  # (sub-units, C)
    return torch.stack([col("a1"), 1.0 / (col("b1") + 1e-9), col("c1b"),
                        col("a2"), 1.0 / (col("b2") + 1e-9), col("c2b")], 1).reshape(-1)


def pack_stage_params(stage_params: List[dict], device) -> tuple:
    """(weights, vectors) as the CUDA-core kernel reads them, f32 on `device`."""
    ws = [p[n].float().reshape(-1) for blk in stage_params for p in blk["sub"]
          for n in ("w1", "w2")]
    return torch.cat(ws).to(device), _pack_vectors(stage_params).to(device)


def pack_conv_mma(w: torch.Tensor) -> torch.Tensor:
    """(..., C_out, C_in, k) conv weights -> their B fragments for the
    tensor-core kernel, int32 (..., steps, NT, 32, 2): bf16 pairs, the lower
    index in the low half.

    K runs over (tap j, 8-channel group cg, channel cc), group q = j*ng + cg
    (ng = ceil(C_in/8)), two groups per k16 step (steps = ceil(k*ng/2)); N
    over C_out in NT = ceil(C_out/8) n8 tiles; channels past C and the group
    past k*ng are zero. Lane g*4 + t4 of step s, tile n holds
    B[k = 16s + 8h + 2t4 + e][n = 8n + g] in register h, half e: the
    m16n8k16 B fragment."""
    *lead, co, ci, k = w.shape
    ng, nt = -(-ci // 8), -(-co // 8)
    nq = k * ng
    steps = -(-nq // 2)
    wq = w.new_zeros((*lead, nt * 8, k, ng * 8), dtype=torch.bfloat16)
    wq[..., :co, :, :ci] = w.transpose(-1, -2).to(torch.bfloat16)
    b = w.new_zeros((*lead, nt * 8, 2 * steps, 8), dtype=torch.bfloat16)
    b[..., :nq, :] = wq.reshape(*lead, nt * 8, nq, 8)
    # (n, q, cc) = (tile, g, step, h, t4, e) -> (step, tile, g, t4, h, e)
    f = b.reshape(*lead, nt, 8, steps, 2, 4, 2)
    nl = len(lead)
    f = f.permute(*range(nl), nl + 2, nl, nl + 1, nl + 4, nl + 3, nl + 5).contiguous()
    return f.view(torch.int32).reshape(*lead, steps, nt, 32, 2)


def pack_stage_params_mma(stage_params: List[dict], device) -> tuple:
    """(B fragments of every conv in stage order [res][sub][conv1, conv2],
    vectors) as the tensor-core kernel reads them, on `device`."""
    frags = []
    for blk in stage_params:
        w = torch.stack([p[n] for p in blk["sub"] for n in ("w1", "w2")]).to(device)
        frags.append(pack_conv_mma(w).reshape(-1))
    return torch.cat(frags), _pack_vectors(stage_params).to(device)


def _pack(stage_params: List[dict], route: str, device) -> tuple:
    return (pack_stage_params_mma if route == "mma" else pack_stage_params)(stage_params, device)


def _launch_cf(xc: torch.Tensor, out: torch.Tensor, packed: tuple, kernel_sizes, dilations,
               fast) -> None:
    """One kernel launch over channels-first contiguous xc (B, C, T) into
    out, on `pick_route(xc)`'s kernel; packed = `_pack(..., route, ...)`.
    K1, K2a and K2b all launch here: the recorder counts `amp_stage.mma` or
    `amp_stage.f32` by route (`obs.count`)."""
    if xc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused AMP stage kernel takes float32 or bfloat16, not {xc.dtype}")
    b, c, t = xc.shape
    r = stage_radius(kernel_sizes, dilations)
    route = pick_route(xc)
    w, vec = packed
    ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
    ds = (ctypes.c_int * len(dilations))(*dilations)
    taps = (ctypes.c_float * 24)(*[v for group in alias_free_taps() for v in group])
    lib = _library()
    fn = lib.amp_stage_mma_launch if route == "mma" else lib.amp_stage_launch
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        rc = fn(xc.data_ptr(), out.data_ptr(), w.data_ptr(), vec.data_ptr(), b, c, t,
                route_tile(route, c, r), r, len(kernel_sizes), len(dilations), ks, ds, int(fast),
                taps, stream)
    if rc != 0:
        raise RuntimeError(f"amp_stage kernel launch failed ({route}): CUDA error {rc}")
    obs.count("amp_stage.mma" if route == "mma" else "amp_stage.f32")


def _check_stage(x: torch.Tensor, stage_params, kernel_sizes, dilations, accum: str) -> None:
    if accum not in ACCUM_MODES:
        raise ValueError(f"accum must be one of {ACCUM_MODES}, got {accum!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x.shape)}")
    if any(k % 2 == 0 for k in kernel_sizes):
        raise ValueError(f"kernel sizes must be odd, got {tuple(kernel_sizes)}")
    if not (1 <= len(kernel_sizes) <= 4 and 1 <= len(dilations) <= 4):
        raise ValueError("the kernel takes 1-4 resblocks of 1-4 sub-units")
    # raises if C is too wide for the route's kernel
    route_tile(pick_route(x), x.shape[-1], stage_radius(kernel_sizes, dilations))
    check_stage_params(stage_params, kernel_sizes, dilations, x.shape[-1])
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused AMP stage runs on cuda or cpu, not {x.device}")


def fused_amp_stage(x: torch.Tensor, stage_params: List[dict],
                    kernel_sizes: Sequence[int] = (3, 7, 11),
                    dilations: Sequence[int] = (1, 3, 5), fast: bool = False,
                    accum: str = "bf16", conv: str = "tap") -> torch.Tensor:
    """(B, T, C) -> (B, T, C): one fused AMP stage, equal to the unfused
    stage everywhere including the first and last samples.

    On a CUDA tensor this launches an sm_90a kernel once for the whole
    batch or raises (bf16: the tensor-core kernel; f32: the CUDA-core
    kernel); on a CPU tensor it runs the plain version. `accum` and `conv`
    are the JAX knobs, accepted and validated: both kernels sum in f32 and
    keep the residual and the resblock mean in f32 (error at or below the
    JAX "bf16" and "f32" modes; bf16 rounds only the conv operands, as the
    TPU kernel does), and one formulation serves all three `conv` values,
    which the JAX package measured to give the same numbers."""
    if conv not in CONV_MODES:
        raise ValueError(f"conv must be one of {CONV_MODES}, got {conv!r}")
    _check_stage(x, stage_params, kernel_sizes, dilations, accum)
    if x.device.type == "cpu":
        return fused_amp_stage_plain(x, stage_params, kernel_sizes, dilations, fast)
    xc = x.transpose(1, 2).contiguous()
    out = torch.empty_like(xc)
    _launch_cf(xc, out, _pack(stage_params, pick_route(xc), x.device), kernel_sizes, dilations,
               fast)
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
    _check_stage(x, stage_params, kernel_sizes, dilations, accum)
    if x.device.type == "cpu":
        return fused_amp_stage_plain(x, stage_params, kernel_sizes, dilations, fast)
    packed, outs = _pack(stage_params, pick_route(x), x.device), []
    for i in range(x.shape[0]):
        xc = x[i:i + 1].transpose(1, 2).contiguous()
        out = torch.empty_like(xc)
        _launch_cf(xc, out, packed, kernel_sizes, dilations, fast)
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
    if conv not in ("tap", "mstack"):
        raise ValueError(f"fused_amp_stage_cl takes conv 'tap' or 'mstack', got {conv!r}")
    _check_stage(x, stage_params, kernel_sizes, dilations, accum)
    if x.device.type == "cpu":
        return fused_amp_stage_plain(x, stage_params, kernel_sizes, dilations, fast)
    xc = x.transpose(1, 2).contiguous()
    out = torch.empty_like(xc)
    packed = _pack(stage_params, pick_route(x), x.device)
    for i in range(x.shape[0]):
        _launch_cf(xc[i:i + 1], out[i:i + 1], packed, kernel_sizes, dilations, fast)
    return out.transpose(1, 2)
