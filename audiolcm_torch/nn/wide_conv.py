"""One resblock conv of the vocoder's wide unfused stages, channels-first,
with the resblock's sums in its epilogue: the CUDA kernel K6
(`csrc/wide_conv.cu`), its plain PyTorch version, and the kernel's tile walk
in torch.

K6 replaces no Pallas kernel: the JAX package leaves these convs to XLA
(`audiolcm_tpu/models/bigvgan.py`). On the card `models/bigvgan.py` runs
every `convs1` / `convs2` conv of an unfused resblock-"1" stage through it
when `takes` holds for the stage's input.

    out = (conv(a) + bias [+ res] [+ acc]) * scale        (B, C, T)

  * `wide_conv` — the wrapper. A CUDA tensor launches the kernel (or raises);
    a CPU tensor runs `wide_conv_plain`.
  * `wide_conv_plain` — `F.conv1d` and the sums in f32, rounded once.
  * `wide_conv_tiles_emulated` — the kernel's algorithm: per block of BM
    samples by `tile` output channels and per 64-channel chunk, one input
    window from a 16-byte aligned start (read as zero outside [0, T) and
    beyond C) that every tap reads at its shift (tap - r) * dilation; the
    products with the weights' tile in f32; then the epilogue. The CPU
    tests hold it against `F.conv1d`.
  * `takes` — the dispatch: bf16 on the card, no gradient recorded, and the
    row strides TMA needs (T and C multiples of ALIGN), contiguous;
    `reaches` — the resblocks' convs fit the window.
  * `pack_weight` — the conv weight (C_out, C_in, k) as the kernel reads
    it, (k, C_out, C_in) contiguous.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from audiolcm_torch import obs

# These must match csrc/wide_conv.cu.
BK = 64  # input channels per K-step
BM = 128  # samples per block: two consumer warpgroups of 64
XWIN = 200  # a chunk's input window: the block's samples and every tap's shift
MAX_REACH = (XWIN - BM - 8) // 2  # (k - 1) / 2 * dilation at most (the window's aligned start)
TILES = (256, 192, 128, 96)  # output channels per block (wgmma's N) the kernel is built for
ALIGN = 8  # TMA: each row's stride, and a window's start, a multiple of 16 bytes (8 bf16)
NUM_SMS = 132  # the H100's multiprocessors, when no card is asked


def reaches(kernel_sizes, dilation_sizes) -> bool:
    """Whether every conv of these resblocks fits K6's window: (k - 1) / 2 *
    dilation <= MAX_REACH (25 in the shipped vocoder)."""
    return all((k - 1) // 2 * d <= MAX_REACH
               for k, ds in zip(kernel_sizes, dilation_sizes) for d in ds)


def takes(x: torch.Tensor) -> bool:
    """Whether K6 runs the convs of a stage whose input is x (B, C, T)."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and not torch.is_grad_enabled()
            and x.dim() == 3 and x.shape[1] % ALIGN == 0 and x.shape[2] % ALIGN == 0
            and x.is_contiguous())


# device time of one wave of blocks per output channel of N, against N = 256
# (a wave: the card's SMs times BLOCKS_PER_SM blocks): the blocks' fixed
# costs and the fragment loads weigh more at small N. Measured over the
# tiles at (8, 768, 2496) on an H100 SXM at 700 W.
COST = {256: 1.0, 192: 1.01, 128: 1.28, 96: 1.58}
BLOCKS_PER_SM = {256: 1, 192: 1, 128: 1, 96: 2}


def pick_tile(c: int, b: int, t: int, sms: int = NUM_SMS) -> int:
    """The block's output channels N: of the TILES that split C into whole
    tiles (all of them if none does), the one whose blocks cost the least in
    waves of the card's `sms` x BLOCKS_PER_SM (waves x N x BLOCKS_PER_SM x
    COST[N]), the wider on a tie."""
    def cost(n):
        per_wave = sms * BLOCKS_PER_SM[n]
        blocks = -(-c // n) * -(-t // BM) * b
        return -(-blocks // per_wave) * n * BLOCKS_PER_SM[n] * COST[n]
    whole = [n for n in TILES if c % n == 0] or list(TILES)
    return min(whole, key=lambda n: (cost(n), -n))


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, k) -> (k, C_out, C_in) contiguous, the kernel's A."""
    return w.permute(2, 0, 1).contiguous()


def _epilogue(y: torch.Tensor, bias, res, acc, scale: float, dtype) -> torch.Tensor:
    y = y + bias.float().view(1, -1, 1)
    if res is not None:
        y = y + res.float()
    if acc is not None:
        y = y + acc.float()
    return (y * scale).to(dtype)


def wide_conv_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, dilation: int,
                    res: Optional[torch.Tensor] = None, acc: Optional[torch.Tensor] = None,
                    scale: float = 1.0) -> torch.Tensor:
    """The same function in plain torch ops: w packed (k, C, C); f32 inside,
    one rounding to a's dtype."""
    k = w.shape[0]
    y = F.conv1d(a.float(), w.float().permute(1, 2, 0), None, padding=(k - 1) // 2 * dilation,
                 dilation=dilation)
    return _epilogue(y, bias, res, acc, scale, a.dtype)


def wide_conv_tiles_emulated(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                             dilation: int, res: Optional[torch.Tensor] = None,
                             acc: Optional[torch.Tensor] = None, scale: float = 1.0,
                             tile: Optional[int] = None) -> torch.Tensor:
    """(B, C, T) computed as csrc/wide_conv.cu walks it: per block (clip,
    `tile` output channels from co0, BM samples from t0) the K-steps in the
    kernel's order, chunk of BK input channels outer and tap inner. Each
    chunk loads one window a[b, chunk, x0 : x0 + XWIN] from x0 = t0 - reach
    rounded down to a multiple of ALIGN (reach = (k - 1) / 2 * d), what lies
    outside the clip or beyond C read as zero (TMA's fill); tap j takes its
    BM samples from offset (t0 - reach - x0) + j * d and adds their products
    with W[j, cols, chunk], in f32; then the epilogue on the block's
    channels and samples inside (C, T)."""
    b, c, t = a.shape
    k = w.shape[0]
    n = tile or pick_tile(c, b, t)
    reach = (k - 1) // 2 * dilation
    if reach > MAX_REACH:
        raise ValueError(f"(k - 1) / 2 * dilation = {reach} exceeds the window's {MAX_REACH}")
    af, wf = a.float(), w.float()
    out = torch.empty(b, c, t)
    for bi in range(b):
        for co0 in range(0, c, n):
            cols = slice(co0, min(co0 + n, c))
            for t0 in range(0, t, BM):
                x0 = (t0 - reach) - (t0 - reach) % ALIGN
                pos = torch.arange(x0, x0 + XWIN)
                inside = (pos >= 0) & (pos < t)
                d = torch.zeros(BM, cols.stop - cols.start)
                for ci0 in range(0, c, BK):
                    chunk = slice(ci0, min(ci0 + BK, c))
                    window = torch.zeros(chunk.stop - chunk.start, XWIN)
                    window[:, inside] = af[bi, chunk][:, pos[inside]]
                    for j in range(k):
                        e = t0 - reach - x0 + j * dilation
                        d += window[:, e:e + BM].T @ wf[j, cols, chunk].T
                m = min(BM, t - t0)
                out[bi, cols, t0:t0 + m] = d[:m].T
    return _epilogue(out, bias, res, acc, scale, a.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    from audiolcm_torch.build import build

    lib = ctypes.CDLL(str(build("wide_conv")))
    lib.wide_conv_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.wide_conv_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def wide_conv(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, dilation: int,
              res: Optional[torch.Tensor] = None, acc: Optional[torch.Tensor] = None,
              scale: float = 1.0) -> torch.Tensor:
    """(B, C, T) -> (B, C, T): (conv(a) + bias [+ res] [+ acc]) * scale, the
    conv "same"-padded with `dilation`, w packed by `pack_weight`.

    On a CUDA tensor this launches the sm_90a kernel once, at the time tile
    `pick_tile`, or raises; on a CPU tensor it runs the plain version."""
    if a.dim() != 3:
        raise ValueError(f"a must be (B, C, T), got shape {tuple(a.shape)}")
    b, c, t = a.shape
    if w.dim() != 3 or tuple(w.shape[1:]) != (c, c) or w.shape[0] % 2 == 0:
        raise ValueError(f"w must be (k, {c}, {c}) with k odd, got {tuple(w.shape)}")
    if tuple(bias.shape) != (c,):
        raise ValueError(f"bias must be ({c},), got {tuple(bias.shape)}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    if a.device.type == "cuda" and (w.shape[0] - 1) // 2 * dilation > MAX_REACH:
        raise ValueError(f"(k - 1) / 2 * dilation exceeds the kernel's window ({MAX_REACH})")
    named = [("a", a), ("w", w), ("bias", bias)] + [(n, v) for n, v in (("res", res),
                                                                       ("acc", acc))
                                                    if v is not None]
    for name, v in named:
        if name in ("res", "acc") and v.shape != a.shape:
            raise ValueError(f"{name} must be {tuple(a.shape)}, got {tuple(v.shape)}")
        if v.dtype != a.dtype:
            raise TypeError(f"wide_conv takes one dtype, {name} is {v.dtype}, a {a.dtype}")
        if v.device != a.device:
            raise ValueError(f"{name} is on {v.device}, a on {a.device}")
        if not v.is_contiguous():
            raise ValueError(f"wide_conv takes contiguous tensors, {name} is not")
    if a.device.type == "cpu":
        return wide_conv_plain(a, w, bias, dilation, res, acc, scale)
    if a.device.type != "cuda":
        raise ValueError(f"wide_conv runs on cuda or cpu, not {a.device}")
    if a.dtype != torch.bfloat16 or c % ALIGN or t % ALIGN:
        raise ValueError(f"the kernel takes bf16 with C and T multiples of {ALIGN}, got "
                         f"{a.dtype} {tuple(a.shape)}")
    out = torch.empty_like(a)
    ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _library().wide_conv_launch(
            a.data_ptr(), w.data_ptr(), bias.data_ptr(), ptr(res), ptr(acc), out.data_ptr(),
            b, c, t, w.shape[0], dilation, float(scale),
            pick_tile(c, b, t, _sms(a.device.index or 0)), stream)
    if rc != 0:
        raise RuntimeError(f"wide_conv kernel launch failed: CUDA error {rc}")
    obs.count("wide_conv")
    return out
