"""One alias-free SnakeBeta of the vocoder, channels-first: the CUDA kernel
K5 (`csrc/alias_free_act.cu`), its plain PyTorch version, and the kernel's
tiling in torch.

K5 replaces no Pallas kernel: the JAX package computes this activation as
the plain jnp chain `audiolcm_tpu/nn/resample.py:212 alias_free_activation`
(`audiolcm_tpu/nn/resample_cf.py:42 alias_free_snake_cf`). On the card
`models/bigvgan.py:Activation1d` runs it for every activation of the
unfused stages and `activation_post` when no gradient is recorded.

  * `alias_free_act` — the wrapper. A CUDA tensor launches the kernel (or
    raises); a CPU tensor runs `alias_free_act_plain`.
  * `alias_free_act_plain` — `resample_cf.alias_free_snake_cf` on the
    linear-scale parameters, in plain torch ops.
  * `alias_free_act_tiles_emulated` — the kernel's algorithm: per time tile,
    the snaked up-phases of the tile and one run of halo on each side from x
    read at clamped positions, the activated signal replicated outside
    [0, T), the down-FIR, f32 inside and one rounding at the output. The CPU
    tests hold it against the JAX package.

Parameters arrive as the module holds them (`SnakeBeta.alpha` / `.beta`,
log-scale or linear, in the module's dtype; `Snake` passes its alpha twice);
the kernel forms alpha and 1 / (beta + 1e-9) in f32 itself.

The kernel's tiling: one block per (row, time tile), each lane a run of RUN
samples; the tile's R = tile / RUN runs plus one halo run on each side take
R + 2 lanes, at most MAX_WARPS warps.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from audiolcm_torch import obs
from audiolcm_torch.nn.resample import alias_free_taps, correlate
from audiolcm_torch.nn.resample_cf import alias_free_snake_cf
from audiolcm_torch.nn.snake import snake_binv

RUN = 16  # samples per lane; these must match csrc/alias_free_act.cu
MAX_WARPS = 8  # warps per block at most


def pick_tile(t: int) -> int:
    """The kernel's time tile for rows of length t, a multiple of RUN: of the
    block widths (1..MAX_WARPS warps) the one that launches the fewest lanes
    for the row's runs (halo lanes and a ragged last tile included), the
    wider on a tie; then the row's runs split evenly over its tiles."""
    if t < 1:
        raise ValueError(f"alias_free_act needs T >= 1, got {t}")
    runs = -(-t // RUN)
    launched = lambda w: -(-runs // (32 * w - 2)) * 32 * w
    warps = min(range(1, MAX_WARPS + 1), key=lambda w: (launched(w), -w))
    n_tiles = -(-runs // (32 * warps - 2))
    return RUN * -(-runs // n_tiles)


def alias_free_act_plain(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                         logscale: bool, fast: bool) -> torch.Tensor:
    """(B, C, T) -> (B, C, T): the polyphase channels-first form in plain
    torch ops, on the parameters made linear in their own dtype, as
    `SnakeBeta.linear_params` makes them."""
    a, b = (torch.exp(alpha), torch.exp(beta)) if logscale else (alpha, beta)
    return alias_free_snake_cf(x, a, b, fast=fast)


def alias_free_act_tiles_emulated(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                                  logscale: bool, fast: bool,
                                  tile: int | None = None) -> torch.Tensor:
    """(B, C, T) computed as csrc/alias_free_act.cu does: per tile
    [t0, t0 + tile), the snaked up-phases at positions [t0 - RUN, t0 + tile
    + RUN) from x read at clamped positions, in f32; positions outside
    [0, T) take ae[0] (left) and ao[T-1] (right), which the block holds;
    then the down-FIR of the tile, rounded once."""
    b, c, t = x.shape
    tile = tile or pick_tile(t)
    if tile % RUN:
        raise ValueError(f"the tile must be a multiple of {RUN}, got {tile}")
    up_e, up_o, dn_e, dn_o = alias_free_taps()
    a, bt = (v.float() for v in (alpha, beta))
    if logscale:
        a, bt = torch.exp(a), torch.exp(bt)
    a, binv = a.view(1, -1, 1), (1.0 / (bt + 1e-9)).view(1, -1, 1)
    xf, n = x.float(), tile + 2 * RUN
    out = torch.empty(b, c, t)
    for t0 in range(0, t, tile):
        pos = torch.arange(t0 - RUN, t0 + tile + RUN)
        win = xf[..., torch.arange(t0 - RUN - 3, t0 + tile + RUN + 3).clamp(0, t - 1)]
        ae = snake_binv(correlate(win, up_e, n, -1), a, binv, fast)
        ao = snake_binv(correlate(win[..., 1:], up_o, n, -1), a, binv, fast)
        ae0 = ae[..., RUN:RUN + 1]  # position 0, when t0 == 0
        aol = ao[..., min(t - 1 - (t0 - RUN), n - 1):][..., :1]  # position T-1, where needed
        for v in (ae, ao):
            v.copy_(torch.where(pos < 0, ae0, torch.where(pos >= t, aol, v)))
        m = min(tile, t - t0)
        out[..., t0:t0 + m] = (correlate(ao[..., RUN - 3:], dn_e, m, -1)
                               + correlate(ae[..., RUN - 2:], dn_o, m, -1))
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    from audiolcm_torch.build import build

    lib = ctypes.CDLL(str(build("alias_free_act")))
    lib.alias_free_act_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.alias_free_act_launch.restype = ctypes.c_int
    return lib


def alias_free_act(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, logscale: bool,
                   fast: bool) -> torch.Tensor:
    """(B, C, T) -> (B, C, T): down2x(snakebeta(up2x(x))) with alpha and beta
    (C,) as the module holds them (log-scale when `logscale`).

    On a CUDA tensor this launches the sm_90a kernel once, at the time tile
    `pick_tile(T)`, or raises; on a CPU tensor it runs the plain version."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, T), got shape {tuple(x.shape)}")
    b, c, t = x.shape
    if tuple(alpha.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"alpha and beta must be ({c},), got {tuple(alpha.shape)} and "
                         f"{tuple(beta.shape)}")
    for name, v in (("x", x), ("alpha", alpha), ("beta", beta)):
        if v.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"alias_free_act takes float32 or bfloat16, {name} is {v.dtype}")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"alias_free_act takes contiguous tensors, {name} is not")
    if alpha.dtype != beta.dtype:
        raise TypeError(f"alpha and beta differ in dtype: {alpha.dtype}, {beta.dtype}")
    if x.device.type == "cpu":
        return alias_free_act_plain(x, alpha, beta, logscale, fast)
    if x.device.type != "cuda":
        raise ValueError(f"alias_free_act runs on cuda or cpu, not {x.device}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _library().alias_free_act_launch(
            x.data_ptr(), out.data_ptr(), alpha.data_ptr(), beta.data_ptr(), b * c, c, t,
            pick_tile(t), int(logscale), int(alpha.dtype == torch.bfloat16), int(fast),
            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"alias_free_act kernel launch failed: CUDA error {rc}")
    obs.count("alias_free_act")
    return out
