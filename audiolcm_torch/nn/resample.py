"""Alias-free (anti-aliased) 1D resampling with kaiser-windowed sinc filters.

Behaviour of the reference `alias_free_torch` modules:
  * kaiser_sinc_filter1d(cutoff, half_width, kernel_size)
  * UpSample1d: replicate-pad, x`ratio` transposed depthwise conv with the
    sinc filter scaled by ratio, asymmetric crop
  * DownSample1d: replicate-pad, depthwise strided conv
  * Activation1d: up(2x) -> act -> down(2x)

The public functions take channels-last (B, T, C) like the JAX package; the
`*_cf` forms take (B, C, T) and are what the vocoder runs.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Lowpass prototype, shape (kernel_size,), sums to 1. Computed in
    float64 and returned as float32."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


@functools.lru_cache(maxsize=None)
def alias_free_taps():
    """Polyphase taps of the 2x alias-free activation, as float64 values of
    the float32 filter: (up_even, up_odd, down_even, down_odd), 6 each.

    ue[j] = sum_d up_even[d] * x[j+d-3], uo[j] = sum_d up_odd[d] * x[j+d-2];
    y[t] = sum_d down_even[d] * ao[t+d-3] + down_odd[d] * ae[t+d-2]."""
    up = kaiser_sinc_filter1d(0.25, 0.3, 12).astype(np.float64) * 2.0
    up_even = tuple(float(up[15 - 2 * d]) for d in range(2, 8))
    up_odd = tuple(float(up[16 - 2 * d]) for d in range(3, 9))
    down = kaiser_sinc_filter1d(0.25, 0.3, 12).astype(np.float64)
    return up_even, up_odd, tuple(float(v) for v in down[0::2]), tuple(float(v) for v in down[1::2])


@functools.lru_cache(maxsize=None)
def _filter_on(ratio: int, kernel_size: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """The (1, 1, K) sinc filter on `device` in `dtype`, built once: a
    forward copies nothing from the host, so it can be captured in a CUDA
    graph. Built outside inference mode, so that a forward under autograd
    may save it."""
    with torch.inference_mode(False):
        f = torch.from_numpy(kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, kernel_size))
        return f.to(device=device, dtype=dtype).view(1, 1, -1)


def _filter(x: torch.Tensor, ratio: int, kernel_size: int) -> torch.Tensor:
    return _filter_on(ratio, kernel_size, x.device, x.dtype).expand(x.shape[1], 1, -1)


def upsample1d_cf(x: torch.Tensor, ratio: int = 2, kernel_size: int | None = None) -> torch.Tensor:
    """(B, C, T) -> (B, C, ratio*T), anti-aliased."""
    kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    pad = kernel_size // ratio - 1
    pad_left = pad * ratio + (kernel_size - ratio) // 2
    pad_right = pad * ratio + (kernel_size - ratio + 1) // 2
    xp = F.pad(x, (pad, pad), mode="replicate")
    out = ratio * F.conv_transpose1d(xp, _filter(x, ratio, kernel_size), stride=ratio,
                                     groups=x.shape[1])
    return out[..., pad_left:-pad_right]


def downsample1d_cf(x: torch.Tensor, ratio: int = 2, kernel_size: int | None = None) -> torch.Tensor:
    """(B, C, T) -> (B, C, T/ratio), anti-aliased."""
    kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    even = kernel_size % 2 == 0
    xp = F.pad(x, (kernel_size // 2 - int(even), kernel_size // 2), mode="replicate")
    return F.conv1d(xp, _filter(x, ratio, kernel_size), stride=ratio, groups=x.shape[1])


def alias_free_activation_cf(x: torch.Tensor, act_fn) -> torch.Tensor:
    """(B, C, T): 2x upsample -> act -> 2x downsample (depthwise-conv form)."""
    return downsample1d_cf(act_fn(upsample1d_cf(x, 2)), 2)


def upsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: int | None = None) -> torch.Tensor:
    """(B, T, C) -> (B, ratio*T, C)."""
    return upsample1d_cf(x.transpose(1, 2), ratio, kernel_size).transpose(1, 2)


def downsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: int | None = None) -> torch.Tensor:
    """(B, T, C) -> (B, T/ratio, C)."""
    return downsample1d_cf(x.transpose(1, 2), ratio, kernel_size).transpose(1, 2)


def alias_free_activation(x: torch.Tensor, act_fn) -> torch.Tensor:
    """(B, T, C) Activation1d; act_fn takes channels-last tensors."""
    return downsample1d(act_fn(upsample1d(x, 2)), 2)


def correlate(xp: torch.Tensor, taps, out_len: int, dim: int) -> torch.Tensor:
    """sum_d taps[d] * xp[d:d+out_len] along `dim`."""
    acc = None
    for d, w in enumerate(taps):
        term = w * xp.narrow(dim, d, out_len)
        acc = term if acc is None else acc + term
    return acc


def alias_free_activation_fused(x: torch.Tensor, act_fn) -> torch.Tensor:
    """(B, T, C) down2x(act(up2x(x))) with the interleave eliminated
    analytically: the up-sampled signal's even/odd phases (ue, uo) are 6-tap
    FIRs of x, and the down filter reads them at fixed phase offsets.
    Boundary = edge replication of the interleaved signal u (u[0] = ae[0],
    u[2T-1] = ao[T-1]), which equals the depthwise-conv form."""
    up_e, up_o, dn_e, dn_o = alias_free_taps()
    t = x.shape[1]
    xp5 = F.pad(x.transpose(1, 2), (5, 5), mode="replicate").transpose(1, 2)
    ae = act_fn(correlate(xp5[:, 2:], up_e, t, 1))
    ao = act_fn(correlate(xp5[:, 3:], up_o, t, 1))
    left = ae[:, :1].expand(-1, 3, -1)
    right = ao[:, -1:].expand(-1, 3, -1)
    ao_p = torch.cat([left, ao, right[:, :2]], dim=1)
    ae_p = torch.cat([left[:, :2], ae, right], dim=1)
    return correlate(ao_p, dn_e, t, 1) + correlate(ae_p, dn_o, t, 1)
