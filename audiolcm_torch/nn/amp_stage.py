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
  * `pack_stage` — a stage's parameters packed once for the kernel of one
    dtype (`PackedStage`; `pack_stage_params_mma` / `pack_conv_wgmma`: the
    tensor-core kernel's weights in its shared-memory layout); every
    wrapper takes a `PackedStage`, which its caller packs.
  * `pick_tile_mma` — the tensor-core kernel's tile from (C, B, T) and the
    SM count; `grid_mma` its grid.

stage_params[b]["sub"][s] = {a1, b1, w1, c1b, a2, b2, w2, c2b}: snake
alpha/beta already exponentiated (linear scale), conv weights in the torch
layout (C_out, C_in, k).
"""

from __future__ import annotations

import ctypes
import dataclasses
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
MMA_MAX_C = 64  # the tensor-core kernel's widest C (wgmma N <= 64); csrc MMA_MAX_NT
MMA_SMEM_SLACK = 64  # csrc SMEM_SLACK
MAX_TILE = 512  # the CUDA-core kernel's longest tile
MAX_TILE_MMA = 1024  # the tensor-core kernel's longest tile (reached at narrow C)
NUM_SMS = 132  # the H100's multiprocessors, when no card is asked
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


def mma_layout(c: int, n: int) -> tuple:
    """(NP, HROWS) of the tensor-core kernel for a window of n samples: the
    row pitch NP of the f32 residual and the bf16 first-conv output, n
    rounded up to 4 mod 8, and the rows of each 8-channel plane of the conv
    input H (16 bytes a row), n + 64 (a ragged 64-sample tile reads past the
    window) rounded up to 1 mod 8."""
    return n + (4 - n) % 8, n + 64 + (1 - (n + 64)) % 8


def conv_groups(c: int, k: int) -> int:
    """The 8-channel groups of one conv's K in the tensor-core kernel:
    (input-channel group, tap) flattened, padded to an even count (two per
    k16 step)."""
    return -(-k * -(-c // 8) // 2) * 2


def smem_bytes_mma(c: int, tile: int, r: int, kmax: int) -> int:
    """The tensor-core kernel's shared memory: one conv's packed weights at
    the stage's largest kernel size, the conv input H (ceil(C / 8) planes of
    HROWS x 8 bf16), the residual (C x NP f32), the resblock sum (C x (tile
    + 4) f32) and the first conv's output G (C x NP bf16), N = tile + 2r."""
    n = tile + 2 * r
    np_, hrows = mma_layout(c, n)
    ng = -(-c // 8)
    return (conv_groups(c, kmax) * ng * 128 + 16 * ng * hrows + 4 * c * (np_ + tile + 4)
            + 2 * c * np_ + MMA_SMEM_SLACK)


def max_tile_mma(c: int, r: int, kmax: int) -> int:
    """The tensor-core kernel's longest tile that fits one block: the
    largest multiple of 8 (<= MAX_TILE_MMA); 168 at C=48 and 616 at C=24
    for the shipped stage (r = 96, k <= 11)."""
    if c > MMA_MAX_C:
        raise ValueError(f"fused AMP stage: the tensor-core kernel takes C <= {MMA_MAX_C}, "
                         f"got C={c}")
    for tile in range(MAX_TILE_MMA, 7, -8):
        if smem_bytes_mma(c, tile, r, kmax) <= SMEM_BYTES:
            return tile
    raise ValueError(f"fused AMP stage: C={c} does not fit shared memory at radius {r}")


def pick_tile_mma(c: int, kernel_sizes: Sequence[int], dilations: Sequence[int], b: int, t: int,
                  sms: int = NUM_SMS) -> int:
    """The tensor-core kernel's tile for a (B, T, C) stage on a card of
    `sms` multiprocessors: of the multiples of 8 up to `max_tile_mma`, the
    one whose grid costs the least, in waves of one block per SM times the
    tile + r samples each of its ops computes on average (the window, tile +
    2r, shrinks to the tile); the longer on a tie. So a batch-1 grid fills
    its last wave rather than leaving most SMs idle in it."""
    return _pick_tile_mma(c, tuple(kernel_sizes), tuple(dilations), b, t, sms)


@functools.lru_cache(maxsize=4096)
def _pick_tile_mma(c: int, kernel_sizes: tuple, dilations: tuple, b: int, t: int,
                   sms: int) -> int:
    r = stage_radius(kernel_sizes, dilations)
    top = max_tile_mma(c, r, max(kernel_sizes))

    def cost(tile):
        return -(-b * -(-t // tile) // sms) * (tile + r)

    return min(range(top, 7, -8), key=lambda tile: (cost(tile), -tile))


def grid_mma(b: int, t: int, tile: int) -> tuple:
    """The tensor-core kernel's grid: (time tiles, batch); block (i, j)
    computes samples [i tile, min((i + 1) tile, T)) of batch element j."""
    return -(-t // tile), b


def pick_route(x: torch.Tensor) -> str:
    """The kernel that a CUDA tensor of x's dtype launches: "mma" (the
    tensor-core kernel) for bf16, "cuda_core" for f32."""
    return route_of(x.dtype)


def route_of(dtype: torch.dtype) -> str:
    return "mma" if dtype == torch.bfloat16 else "cuda_core"


def route_tile(route: str, c: int, kernel_sizes: Sequence[int], dilations: Sequence[int],
               b: int, t: int, sms: int = NUM_SMS) -> int:
    """The tile a (B, T, C) stage launches at on `route`'s kernel."""
    if route == "mma":
        return pick_tile_mma(c, kernel_sizes, dilations, b, t, sms)
    return pick_tile(c, stage_radius(kernel_sizes, dilations))


def route_takes(dtype: torch.dtype, c: int, kernel_sizes: Sequence[int],
                dilations: Sequence[int]) -> bool:
    """Whether the kernel route of `dtype` has a tile for C in this stage
    (bf16: the tensor-core kernel, f32: the CUDA-core kernel; no other
    dtype has a kernel). Never raises, and answers the same on any device,
    so a caller can decide before any launch which stages to fuse."""
    r = stage_radius(kernel_sizes, dilations)
    if dtype == torch.bfloat16:
        return c <= MMA_MAX_C and smem_bytes_mma(c, 8, r, max(kernel_sizes)) <= SMEM_BYTES
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
    first/last sample), the output rounded to x's dtype once. Every tile's
    window is computed at once, as a batch of windows.

    The numerics are those of the kernel a CUDA tensor of x's dtype runs
    (`pick_route`), and `tile` defaults to that route's tile for x's shape
    on an H100 (`route_tile`). f32 is the
    CUDA-core kernel: f32 inside. bf16 is the tensor-core kernel: each
    conv's input and weights rounded to bf16, f32 sums, the first conv's
    output (G) rounded to bf16, everything else (residual, resblock mean,
    activations) f32."""
    up_e, up_o, dn_e, dn_o = alias_free_taps()
    b, t, c = x.shape
    r = stage_radius(kernel_sizes, dilations)
    route = pick_route(x)
    tile = tile or route_tile(route, c, kernel_sizes, dilations, b, t)
    n = tile + 2 * r
    nt = -(-t // tile)
    rnd = (lambda v: v.bfloat16().float()) if route == "mma" else (lambda v: v)
    sp = [{"sub": [{k: v.float() for k, v in s.items()} for s in blk["sub"]]}
          for blk in stage_params]
    # window w = (batch element, tile) covers global positions g[w] = base[w] + 0 .. n - 1
    base = (torch.arange(nt) * tile - r).repeat(b)  # (b nt,)
    g = base[:, None] + torch.arange(n)  # (b nt, n)
    inside = (g >= 0) & (g < t)

    def gather(inp, pos, taps, shift):
        """sum_d taps[d] * inp at global pos + d - shift clamped to [0, T), per
        window (sequential sum over d); inp (W, C, n), pos (W, m)."""
        m = pos.shape[1]
        idx = (pos[:, :, None] + torch.arange(6) - shift).clamp(0, t - 1) - base[:, None, None]
        idx = idx.clamp(0, n - 1).reshape(-1, 1, m * 6).expand(-1, c, -1)
        vals = inp.gather(-1, idx).reshape(-1, c, m, 6)
        acc = None
        for d, w in enumerate(taps):
            term = w * vals[..., d]
            acc = term if acc is None else acc + term
        return acc

    def act(inp, lo, hi, alpha, beta):
        # snaked up-phases over [lo-3, hi+3), clamped global reads
        ge = g[:, lo - 3:hi + 3]
        a = alpha[:, None]
        binv = (1.0 / (beta + 1e-9))[:, None]
        snk = lambda u: snake_binv(u, a, binv, fast)  # noqa: E731
        e = snk(gather(inp, ge.clamp(0, t - 1), up_e, 3))
        o = snk(gather(inp, ge.clamp(0, t - 1), up_o, 2))
        # u[0] = ae[0] before the first sample, u[2T-1] = ao[T-1] past the last
        # (each read only matters in the windows that hold that edge)
        left = snk(gather(inp, torch.zeros_like(ge[:, :1]), up_e, 3))
        right = snk(gather(inp, torch.full_like(ge[:, :1], t - 1), up_o, 2))
        before, past = (ge < 0)[:, None], (ge >= t)[:, None]
        e = torch.where(before, left, torch.where(past, right, e))
        o = torch.where(before, left, torch.where(past, right, o))
        y = correlate(o, dn_e, hi - lo, -1) + correlate(e[..., 1:], dn_o, hi - lo, -1)
        res = torch.zeros_like(inp)
        res[..., lo:hi] = torch.where(inside[:, None, lo:hi], y, 0.0)
        return res

    def conv(inp, lo, hi, w, bias, d):
        half = (w.shape[-1] - 1) // 2 * d
        res = torch.zeros_like(inp)
        res[..., lo:hi] = F.conv1d(rnd(inp[..., lo - half:hi + half]), rnd(w), bias, dilation=d)
        return res

    xc = x.transpose(1, 2).float()  # (b, c, t)
    window = xc[:, :, g[:nt].clamp(0, t - 1)].transpose(1, 2)  # (b, nt, c, n)
    window = torch.where(inside.view(b, nt, 1, n), window, 0.0).reshape(b * nt, c, n)
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
    out = (acc / len(kernel_sizes)).view(b, nt, c, tile).transpose(1, 2).reshape(b, c, nt * tile)
    return out[..., :t].to(x.dtype).transpose(1, 2)


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


def pack_conv_wgmma(w: torch.Tensor) -> torch.Tensor:
    """(..., C, C, k) conv weights (C_out, C_in, tap) -> the tensor-core
    kernel's B, bf16 (..., groups, 8 ng, 8), ng = ceil(C / 8): K runs over
    (input-channel group u, tap j), group q = u k + j, and group q is a
    (C_out rounded up to 8) x 8 block, row n = output channel n, column e =
    input channel 8u + e of tap j: the wgmma core matrices, 8 rows of 16
    bytes, stored in order. groups = `conv_groups(C, k)`; channels past C
    and the padded group are zero."""
    *lead, co, ci, k = w.shape
    ng = -(-ci // 8)
    nq = k * ng
    wt = w.new_zeros((*lead, co, ng * 8, k), dtype=torch.bfloat16)
    wt[..., :ci, :] = w.to(torch.bfloat16)
    nl = len(lead)  # (..., co, u, e, j) -> (..., u, j, co, e)
    wt = wt.reshape(*lead, co, ng, 8, k).permute(*range(nl), nl + 1, nl + 3, nl, nl + 2)
    b = w.new_zeros((*lead, conv_groups(ci, k), -(-co // 8) * 8, 8), dtype=torch.bfloat16)
    b[..., :nq, :co, :] = wt.reshape(*lead, nq, co, 8)
    return b


def pack_stage_params_mma(stage_params: List[dict], device) -> tuple:
    """(every conv's `pack_conv_wgmma` in stage order [res][sub][conv1,
    conv2], flattened; vectors) as the tensor-core kernel reads them, on
    `device`."""
    packs = []
    for blk in stage_params:
        w = torch.stack([p[n] for p in blk["sub"] for n in ("w1", "w2")]).to(device)
        packs.append(pack_conv_wgmma(w).reshape(-1))
    return torch.cat(packs), _pack_vectors(stage_params).to(device)


@dataclasses.dataclass(frozen=True)
class PackedStage:
    """A stage's parameters packed once for the kernel that a tensor of
    `dtype` on `device` launches (`pack_stage`): `weights` and `vectors` as
    that kernel reads them; `params`, the stage params themselves, for the
    plain version off the card."""
    params: List[dict]
    dtype: torch.dtype
    device: torch.device
    weights: torch.Tensor
    vectors: torch.Tensor


def pack_stage(stage_params: List[dict], kernel_sizes: Sequence[int], dilations: Sequence[int],
               dtype: torch.dtype, device) -> PackedStage:
    """Packs stage_params for the kernel route of `dtype` (`route_of`) on
    `device`, after checking their shapes. No gradient flows through the
    packing: the kernels have no backward."""
    c = stage_params[0]["sub"][0]["w1"].shape[0] if stage_params and stage_params[0]["sub"] else 0
    check_stage_params(stage_params, kernel_sizes, dilations, c)
    pack = pack_stage_params_mma if route_of(dtype) == "mma" else pack_stage_params
    with torch.no_grad():
        weights, vectors = pack(stage_params, device)
    return PackedStage(stage_params, dtype, torch.device(device), weights, vectors)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_cf(xc: torch.Tensor, out: torch.Tensor, packed: PackedStage, kernel_sizes, dilations,
               fast) -> None:
    """One kernel launch over channels-first contiguous xc (B, C, T) into
    out, on `pick_route(xc)`'s kernel at its tile for xc's shape on this
    card. K1, K2a and K2b all launch here: the recorder counts
    `amp_stage.mma` or `amp_stage.f32` by route (`obs.count`)."""
    if xc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused AMP stage kernel takes float32 or bfloat16, not {xc.dtype}")
    b, c, t = xc.shape
    r = stage_radius(kernel_sizes, dilations)
    route = pick_route(xc)
    tile = route_tile(route, c, kernel_sizes, dilations, b, t, _sms(xc.device.index or 0))
    ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
    ds = (ctypes.c_int * len(dilations))(*dilations)
    taps = (ctypes.c_float * 24)(*[v for group in alias_free_taps() for v in group])
    lib = _library()
    fn = lib.amp_stage_mma_launch if route == "mma" else lib.amp_stage_launch
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        rc = fn(xc.data_ptr(), out.data_ptr(), packed.weights.data_ptr(),
                packed.vectors.data_ptr(), b, c, t, tile, r, len(kernel_sizes), len(dilations), ks,
                ds, int(fast), taps, stream)
    if rc != 0:
        raise RuntimeError(f"amp_stage kernel launch failed ({route}): CUDA error {rc}")
    obs.count("amp_stage.mma" if route == "mma" else "amp_stage.f32")


def _check_stage(x: torch.Tensor, packed: PackedStage, kernel_sizes, dilations,
                 accum: str) -> None:
    if accum not in ACCUM_MODES:
        raise ValueError(f"accum must be one of {ACCUM_MODES}, got {accum!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x.shape)}")
    if any(k % 2 == 0 for k in kernel_sizes):
        raise ValueError(f"kernel sizes must be odd, got {tuple(kernel_sizes)}")
    if not (1 <= len(kernel_sizes) <= 4 and 1 <= len(dilations) <= 4):
        raise ValueError("the kernel takes 1-4 resblocks of 1-4 sub-units")
    b, t, c = x.shape
    route_tile(pick_route(x), c, kernel_sizes, dilations, b, t)  # raises if C is too wide
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused AMP stage runs on cuda or cpu, not {x.device}")
    if not isinstance(packed, PackedStage):
        raise TypeError(f"the stage's parameters come packed (`pack_stage`), not as "
                        f"{type(packed).__name__}")
    if (packed.dtype, packed.device) != (x.dtype, x.device):
        raise ValueError(f"the stage is packed for {packed.dtype} on {packed.device}, "
                         f"x is {x.dtype} on {x.device}")
    check_stage_params(packed.params, kernel_sizes, dilations, c)


def fused_amp_stage(x: torch.Tensor, packed: PackedStage,
                    kernel_sizes: Sequence[int] = (3, 7, 11),
                    dilations: Sequence[int] = (1, 3, 5), fast: bool = False,
                    accum: str = "bf16", conv: str = "tap") -> torch.Tensor:
    """(B, T, C) -> (B, T, C): one fused AMP stage, equal to the unfused
    stage everywhere including the first and last samples.

    On a CUDA tensor this launches an sm_90a kernel once for the whole
    batch or raises (bf16: the tensor-core kernel; f32: the CUDA-core
    kernel); on a CPU tensor it runs the plain version. `packed` is the
    stage's parameters packed for x's dtype and device (`pack_stage`).
    `accum` and `conv` are the JAX knobs, accepted and validated: both
    kernels sum in f32 and keep the residual and the resblock mean in f32
    (error at or below the JAX "bf16" and "f32" modes; bf16 rounds only the
    conv operands, as the TPU kernel does), and one formulation serves all
    three `conv` values, which the JAX package measured to give the same
    numbers."""
    if conv not in CONV_MODES:
        raise ValueError(f"conv must be one of {CONV_MODES}, got {conv!r}")
    _check_stage(x, packed, kernel_sizes, dilations, accum)
    if x.device.type == "cpu":
        return fused_amp_stage_plain(x, packed.params, kernel_sizes, dilations, fast)
    xc = x.transpose(1, 2).contiguous()
    out = torch.empty_like(xc)
    _launch_cf(xc, out, packed, kernel_sizes, dilations, fast)
    return out.transpose(1, 2)


def fused_amp_stage_tc(x: torch.Tensor, packed: PackedStage,
                       kernel_sizes: Sequence[int] = (3, 7, 11),
                       dilations: Sequence[int] = (1, 3, 5), fast: bool = False,
                       accum: str = "bf16") -> torch.Tensor:
    """K2a, `audiolcm_tpu/nn/pallas_amp_stage.py:fused_amp_stage`: the same
    stage with the TPU kernel's launch structure, one launch per batch
    element, each on that element's own (T, C) -> (C, T) transpose. The
    JAX `reference_fn` and `tile` are not taken: the kernel computes the
    edges itself and masks a ragged last tile. CPU: the plain version."""
    _check_stage(x, packed, kernel_sizes, dilations, accum)
    if x.device.type == "cpu":
        return fused_amp_stage_plain(x, packed.params, kernel_sizes, dilations, fast)
    outs = []
    for i in range(x.shape[0]):
        xc = x[i:i + 1].transpose(1, 2).contiguous()
        out = torch.empty_like(xc)
        _launch_cf(xc, out, packed, kernel_sizes, dilations, fast)
        outs.append(out.transpose(1, 2))
    return torch.cat(outs)


def fused_amp_stage_cl(x: torch.Tensor, packed: PackedStage,
                       kernel_sizes: Sequence[int] = (3, 7, 11),
                       dilations: Sequence[int] = (1, 3, 5), fast: bool = False,
                       accum: str = "bf16", conv: str = "tap") -> torch.Tensor:
    """K2b, `audiolcm_tpu/nn/pallas_amp_stage.py:fused_amp_stage_cl`: the
    channels-first form, one (B, T, C) -> (B, C, T) transpose for the batch
    and then one launch per batch element on its (C, T) slice. conv="kstack"
    is refused, as the JAX function refuses it. CPU: the plain version."""
    if conv not in ("tap", "mstack"):
        raise ValueError(f"fused_amp_stage_cl takes conv 'tap' or 'mstack', got {conv!r}")
    _check_stage(x, packed, kernel_sizes, dilations, accum)
    if x.device.type == "cpu":
        return fused_amp_stage_plain(x, packed.params, kernel_sizes, dilations, fast)
    xc = x.transpose(1, 2).contiguous()
    out = torch.empty_like(xc)
    for i in range(x.shape[0]):
        _launch_cf(xc[i:i + 1], out[i:i + 1], packed, kernel_sizes, dilations, fast)
    return out.transpose(1, 2)
