"""The reference's arithmetic: float32 everywhere, or the control's fp8.

In "f32" mode everything runs in float32 with TF32 off (`strict_f32`). In
"fp8" mode (`computed_in`) the reference is computed one precision below
the bfloat16 the configurations state, which `correct` has to reject:
every operation's float result is rounded to float8 e4m3 with one scale
per tensor (amax -> 448, the usual fp8 recipe), as an fp8 program stores
its activations, and both operands of every product with learned weights
(`Precision.gemm_operand`) are rounded likewise; products accumulate in
float32. Rounding only the products' operands would leave the element-wise
work, norms and residual sums more precise than the bf16 program's.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

FP8_MAX = 448.0  # largest finite float8_e4m3fn


@contextlib.contextmanager
def strict_f32():
    """TF32 off for matmuls and cuDNN convs inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale, back in float32."""
    scale = FP8_MAX / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision must be 'f32' or 'fp8', got {name!r}")
        self.name = name

    def gemm_operand(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return fp8_round(x) if self.name == "fp8" else x


F32 = Precision("f32")

# functions that only move, view or cast values: their results are not rounded again
_MOVES = frozenset(("__getitem__", "reshape", "view", "transpose", "permute", "contiguous",
                    "chunk", "split", "expand", "expand_as", "flatten", "squeeze", "unsqueeze",
                    "float", "to", "clone", "cat", "stack", "narrow", "flip",
                    "repeat_interleave", "detach", "t", "unbind", "__get__"))


class _RoundEveryResult(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (isinstance(out, torch.Tensor) and out.dtype == torch.float32 and out.numel() > 1
                and getattr(func, "__name__", "") not in _MOVES):
            return fp8_round(out)
        return out


def computed_in(p: Precision):
    """The context the reference runs in: every result rounded to fp8 in
    "fp8" mode, nothing in "f32" mode."""
    return _RoundEveryResult() if p.name == "fp8" else contextlib.nullcontext()


def linear(p: Precision, x, w, b=None):
    return F.linear(p.gemm_operand(x), p.gemm_operand(w), None if b is None else b.float())


def matmul(p: Precision, a, b):
    return torch.matmul(p.gemm_operand(a), p.gemm_operand(b))


def conv1d(p: Precision, x, w, b=None, stride: int = 1, padding: int = 0, dilation: int = 1):
    return F.conv1d(p.gemm_operand(x), p.gemm_operand(w), None if b is None else b.float(),
                    stride=stride, padding=padding, dilation=dilation)


def conv_transpose1d(p: Precision, x, w, b, stride: int, padding: int):
    return F.conv_transpose1d(p.gemm_operand(x), p.gemm_operand(w), b.float(), stride=stride,
                              padding=padding)


def layer_norm(x, w, b, eps: float):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps)


def group_norm(x, groups: int, w, b, eps: float):
    """x channels-first (B, C, T)."""
    return F.group_norm(x, groups, w.float(), b.float(), eps)


def attention(p: Precision, q, k, v, scale: float, bias=None):
    """q, k, v (B, H, T, d) -> (B, H, T, d); softmax in float32."""
    logits = matmul(p, q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    return matmul(p, torch.softmax(logits, dim=-1), v)
