"""Chain of alias-free SnakeBeta activations: the CUDA kernel K4
(`csrc/act_chain.cu`), its plain PyTorch version, and the kernel's tiling
in torch.

It replaces the TPU kernel `tools/profile_stage_interior.py:110
act_only_fn`, the micro-kernel with which the stage-interior profiler
(`audiolcm_torch/tools/profile_stage_interior.py`) times one alias-free
SnakeBeta unit of the fused AMP stage alone: `n_rep` chained "valid"
activations (`amp_stage.valid_alias_free_snake_cl`, the same alpha and beta
each time) of the edge-padded input, (B, T, C) in, (B, C, T) out.

  * `act_chain` — the wrapper. A CUDA tensor launches the kernel (or
    raises); a CPU tensor runs `act_chain_plain`.
  * `act_chain_plain` — edge pad by `halo(n_rep)` = 6 * n_rep, then the
    n_rep valid activations, in plain torch ops in x's dtype.
  * `act_chain_tiles_emulated` — the kernel's algorithm: one window of
    tile + 2 * `margin(n_rep)` samples per tile, read at positions clamped
    to [0, T), f32 inside, one rounding at the output, a ragged last tile
    kept. The CPU tests hold it against the JAX tool.

The kernel's tiling: one warp per channel runs the chain over a window of
WINDOW samples in shared memory, in chunks of CHUNK, each lane a run of
RUN samples in registers, 30 of a warp's 32 runs written per chunk. The
window is the tile plus, on each side, a margin of the chain's receptive
radius rounded up to RUN (`pick_tile`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from audiolcm_torch import obs
from audiolcm_torch.nn.amp_stage import R_ACT, valid_alias_free_snake_cl
from audiolcm_torch.nn.resample import alias_free_taps

ACT_CG = 8  # channels per thread block, one warp each; these must match csrc/act_chain.cu
RUN = 16  # samples per lane
RUN_PITCH = 20  # floats between runs in shared memory
CHUNK = 30 * RUN  # samples a warp writes per pass over 32 runs
WINDOW = 4 * CHUNK  # samples per window: tile + 2 * margin
# The longest chain the wrapper takes: the 18 activations of one fused AMP
# stage. Longer chains amplify f32 rounding (x + sin^2 grows the signal and
# its error with every activation), so that two f32 evaluations in another
# order no longer agree to the kernel's 1e-4 check against its plain version.
MAX_NREP = 18


def halo(n_rep: int) -> int:
    """The chain's receptive radius: 6 samples per activation."""
    return R_ACT * n_rep


def margin(n_rep: int) -> int:
    """The window's margin on each side of the tile: the halo rounded up to
    RUN, so that the tile starts on a run."""
    return -(-halo(n_rep) // RUN) * RUN


def smem_bytes(tile: int, n_rep: int) -> int:
    """One f32 row per channel: the window's runs plus a margin run on each
    side, RUN_PITCH floats apart."""
    runs = (tile + 2 * margin(n_rep)) // RUN
    return 4 * ACT_CG * (runs + 2) * RUN_PITCH


def pick_tile(n_rep: int) -> int:
    """The kernel's time tile: the window minus its margins, a multiple of
    RUN (1888 at n_rep 1-2, 1824 at n_rep 3-8, 1696 at MAX_NREP)."""
    if not 1 <= n_rep <= MAX_NREP:
        raise ValueError(f"act_chain takes n_rep in [1, {MAX_NREP}], got {n_rep}: longer chains "
                         "amplify f32 rounding past the kernel's check against its plain version")
    return WINDOW - 2 * margin(n_rep)


def act_chain_plain(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, n_rep: int,
                    fast: bool = True) -> torch.Tensor:
    """(B, T, C) -> (B, C, T): edge pad, then n_rep valid activations, in
    x's dtype."""
    h = halo(n_rep)
    xc = F.pad(x.transpose(1, 2), (h, h), mode="replicate")
    a, b = alpha.to(x.dtype), beta.to(x.dtype)
    for _ in range(n_rep):
        xc = valid_alias_free_snake_cl(xc, a, b, fast)
    return xc


def act_chain_tiles_emulated(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                             n_rep: int, fast: bool = True,
                             tile: int | None = None) -> torch.Tensor:
    """(B, T, C) -> (B, C, T) computed as csrc/act_chain.cu does: per tile,
    the window [t0 - margin, t0 + tile + margin) read at clamped positions,
    n_rep activations in f32, the tile's centre rounded once. (The kernel
    runs every activation over the whole window and lets the samples near
    its ends go wrong; here the valid activations drop them instead. The
    centre is the same.)"""
    b, t, c = x.shape
    tile = tile or pick_tile(n_rep)
    m, h = margin(n_rep), halo(n_rep)
    xc, a, bt = x.transpose(1, 2).float(), alpha.float(), beta.float()
    out = torch.empty(b, c, t)
    for t0 in range(0, t, tile):
        win = xc[..., torch.arange(t0 - m, t0 + tile + m).clamp(0, t - 1)]
        for _ in range(n_rep):
            win = valid_alias_free_snake_cl(win, a, bt, fast)
        end = min(t0 + tile, t)
        out[..., t0:end] = win[..., m - h:m - h + end - t0]
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _taps():
    return (ctypes.c_float * 24)(*[v for group in alias_free_taps() for v in group])


@functools.lru_cache(maxsize=None)
def _library():
    from audiolcm_torch.build import build

    lib = ctypes.CDLL(str(build("act_chain")))
    lib.act_chain_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p])
    lib.act_chain_launch.restype = ctypes.c_int
    return lib


def act_chain(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, n_rep: int,
              fast: bool = True) -> torch.Tensor:
    """(B, T, C) -> (B, C, T): n_rep chained alias-free SnakeBetas of the
    edge-padded x, alpha and beta (C,) in linear scale.

    On a CUDA tensor this launches the sm_90a kernel once, at the time tile
    `pick_tile(n_rep)`, or raises; on a CPU tensor it runs the plain
    version. n_rep is at most MAX_NREP on either device."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if tuple(alpha.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"alpha and beta must be ({c},), got {tuple(alpha.shape)} and "
                         f"{tuple(beta.shape)}")
    if not isinstance(n_rep, int):
        raise ValueError(f"n_rep must be an int, got {n_rep!r}")
    tile = pick_tile(n_rep)
    if x.device.type == "cpu":
        return act_chain_plain(x, alpha, beta, n_rep, fast)
    if x.device.type != "cuda":
        raise ValueError(f"act_chain runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"act_chain kernel takes float32 or bfloat16, not {x.dtype}")
    b, t, _ = x.shape
    out = torch.empty(b, c, t, device=x.device, dtype=x.dtype)
    vec = torch.cat([alpha, beta]).to(device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _library().act_chain_launch(
            x.data_ptr(), out.data_ptr(), vec.data_ptr(), b, c, t, *x.stride(), tile,
            margin(n_rep), n_rep, int(fast), int(x.dtype == torch.bfloat16), _taps(), stream)
    if rc != 0:
        raise RuntimeError(f"act_chain kernel launch failed: CUDA error {rc}")
    obs.count("act_chain")
    return out
