"""Dynamic-int8 1D convolution for BigVGAN's wide stages, a parity knob
(`audiolcm_tpu/nn/int8_conv.py`).

Activations are quantised per tensor, weights per output channel, both
symmetric to [-127, 127] with round-half-to-even; each tap's product is
accumulated exactly in int32 and the epilogue rescales in f32 and adds the
bias, as the JAX function does. The product is `torch._int_mm`, a library
call: in JAX it is XLA's `dot_general`, not a Pallas kernel. On the card it
is cuBLASLt's int8 GEMM, which takes M > 16 and K, N multiples of 8; a
shape outside that raises on every device, and no other path runs in its
place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def quantize_per_tensor(x: torch.Tensor):
    """x -> (int8 q, f32 scale), symmetric over the whole tensor."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-20) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def quantize_weight_per_cout(w: torch.Tensor):
    """(C_out, C_in, k) in the torch Conv1d layout -> (int8 q, (C_out,) f32
    scales), symmetric per output channel."""
    wf = w.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(dim=(1, 2)), min=1e-20) / 127.0
    q = torch.clamp(torch.round(wf / scale[:, None, None]), -127.0, 127.0).to(torch.int8)
    return q, scale


def check_int_mm_shape(m: int, k: int, n: int) -> None:
    """The shapes cuBLASLt's int8 GEMM takes: M > 16, K and N multiples of 8."""
    if not (m > 16 and k % 8 == 0 and n % 8 == 0):
        raise ValueError(f"the int8 product takes M > 16 and K, N multiples of 8; got "
                         f"M={m} (batch x time), K={k} (C_in), N={n} (C_out)")


def int8_conv1d_cl(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   dilation: int) -> torch.Tensor:
    """(B, T, C_in) x (C_out, C_in, k) -> (B, T, C_out), 'same' zero
    padding, int8 x int8 -> int32 products per tap; the result in x's
    dtype."""
    b, t, c_in = x.shape
    c_out, _, k = w.shape
    check_int_mm_shape(b * t, c_in, c_out)
    pad = (k * dilation - dilation) // 2
    wq, wscale = quantize_weight_per_cout(w)
    wq = wq.permute(2, 1, 0).contiguous()  # (k, C_in, C_out)
    xq, ascale = quantize_per_tensor(x)
    xq = F.pad(xq, (0, 0, pad, pad))
    acc = None
    for j in range(k):
        tap = xq[:, j * dilation:j * dilation + t].reshape(b * t, c_in)
        term = torch._int_mm(tap, wq[j])
        acc = term if acc is None else acc + term
    y = acc.to(torch.float32) * (ascale * wscale) + bias.to(torch.float32)
    return y.reshape(b, t, c_out).to(x.dtype)
