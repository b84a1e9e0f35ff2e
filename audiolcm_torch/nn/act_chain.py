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
  * `act_chain_plain` — edge pad by 6 * n_rep, then the n_rep valid
    activations, in plain torch ops in x's dtype.
  * `act_chain_tiles_emulated` — the kernel's algorithm: one window of
    tile + 12 * n_rep samples per tile, read at positions clamped to
    [0, T), f32 inside, one rounding at the output, a ragged last tile
    kept. The CPU tests hold it against the JAX tool.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from audiolcm_torch.nn.amp_stage import R_ACT, SMEM_BYTES, valid_alias_free_snake_cl
from audiolcm_torch.nn.resample import alias_free_taps

# Kernel launches since the last reset (chip_smoke sets it to 0 around a run).
LAUNCHES = 0

ACT_CG = 8  # channels per thread block; must match csrc/act_chain.cu
MAX_TILE = 512


def halo(n_rep: int) -> int:
    """The chain's receptive radius: 6 samples per activation."""
    return R_ACT * n_rep


def smem_bytes(tile: int, n_rep: int) -> int:
    return 4 * 3 * ACT_CG * ((tile + 2 * halo(n_rep)) | 1)


def pick_tile(n_rep: int) -> int:
    """Largest multiple of 32 (<= MAX_TILE) whose three f32 rows of ACT_CG
    channels fit one block's shared memory: 512 up to n_rep 158."""
    for tile in range(MAX_TILE, 31, -32):
        if smem_bytes(tile, n_rep) <= SMEM_BYTES:
            return tile
    raise ValueError(f"act_chain: n_rep={n_rep} does not fit shared memory")


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
    """(B, T, C) -> (B, C, T) computed as csrc/act_chain.cu does."""
    b, t, c = x.shape
    tile = tile or pick_tile(n_rep)
    h = halo(n_rep)
    xc, a, bt = x.transpose(1, 2).float(), alpha.float(), beta.float()
    out = torch.empty(b, c, t)
    for t0 in range(0, t, tile):
        win = xc[..., torch.arange(t0 - h, t0 + tile + h).clamp(0, t - 1)]
        for _ in range(n_rep):
            win = valid_alias_free_snake_cl(win, a, bt, fast)
        end = min(t0 + tile, t)
        out[..., t0:end] = win[..., :end - t0]
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    from audiolcm_torch.build import build

    lib = ctypes.CDLL(str(build("act_chain")))
    lib.act_chain_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p])
    lib.act_chain_launch.restype = ctypes.c_int
    return lib


def act_chain(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, n_rep: int,
              fast: bool = True) -> torch.Tensor:
    """(B, T, C) -> (B, C, T): n_rep chained alias-free SnakeBetas of the
    edge-padded x, alpha and beta (C,) in linear scale.

    On a CUDA tensor this launches the sm_90a kernel once, at the time tile
    `pick_tile(n_rep)`, or raises; on a CPU tensor it runs the plain
    version."""
    global LAUNCHES
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if tuple(alpha.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"alpha and beta must be ({c},), got {tuple(alpha.shape)} and "
                         f"{tuple(beta.shape)}")
    if not (isinstance(n_rep, int) and n_rep >= 1):
        raise ValueError(f"n_rep must be a positive int, got {n_rep!r}")
    if x.device.type == "cpu":
        return act_chain_plain(x, alpha, beta, n_rep, fast)
    if x.device.type != "cuda":
        raise ValueError(f"act_chain runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"act_chain kernel takes float32 or bfloat16, not {x.dtype}")
    tile = pick_tile(n_rep)
    b, t, _ = x.shape
    out = torch.empty(b, c, t, device=x.device, dtype=x.dtype)
    vec = torch.cat([alpha.float(), 1.0 / (beta.float() + 1e-9)]).to(x.device)
    taps = (ctypes.c_float * 24)(*[v for group in alias_free_taps() for v in group])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _library().act_chain_launch(
            x.data_ptr(), out.data_ptr(), vec.data_ptr(), b, c, t, *x.stride(), tile, n_rep,
            int(fast), int(x.dtype == torch.bfloat16), taps, stream)
    if rc != 0:
        raise RuntimeError(f"act_chain kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
