"""Multi-head self-attention for the DiT backbone.

Reference `CrossAttention` with no context: q/k/v are bias-free
projections, the output projection (`to_out.0`) has a bias, softmax over
keys in float32, scale = head_dim**-0.5.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audiolcm_torch.nn.flash_attention import flash_attention


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, Tq, d), k/v: (B, H, Tk, d) -> (B, H, Tq, d); f32 softmax.
    `bias` (f32, broadcast to (B, H, Tq, Tk)) is added to the scaled logits,
    as a padding mask's `padding_bias`."""
    logits = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) * scale
    if bias is not None:
        logits = logits + bias
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def padding_bias(attention_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A (B, Tk) 1/0 attention mask -> the (B, 1, 1, Tk) f32 logit bias, -1e9
    on padding (the JAX towers' `(1 - mask) * -1e9`); None stays None."""
    if attention_mask is None:
        return None
    return (1.0 - attention_mask[:, None, None, :].to(torch.float32)) * -1e9


class MultiHeadSelfAttention(nn.Module):
    """Self-attention over (B, T, C).

    use_flash=True runs `nn/flash_attention.flash_attention`: the sm_90a
    kernel on the card, and on the CPU its plain version (f32 logits and
    P.V whatever the stream dtype), as the JAX package runs its Pallas
    kernel in interpret mode off the TPU. It never falls back to the einsum
    path.

    fuse_qkv=True runs the three projections as one (3*inner, C) matmul
    under `to_qkv` (see `fuse_qkv_state_dict`); numerics-preserving. The
    head splits of its chunks are strided views, which the kernel reads in
    place."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 use_flash: bool = False, fuse_qkv: bool = False):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.use_flash, self.fuse_qkv = use_flash, fuse_qkv
        if fuse_qkv:
            self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        else:
            self.to_q = nn.Linear(dim, inner, bias=False)
            self.to_k = nn.Linear(dim, inner, bias=False)
            self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        if self.fuse_qkv:
            q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        else:
            q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        split = lambda a: a.reshape(b, t, self.num_heads, self.head_dim).transpose(1, 2)
        attend = flash_attention if self.use_flash else dot_product_attention
        out = attend(split(q), split(k), split(v), self.head_dim**-0.5)
        return self.to_out(out.transpose(1, 2).reshape(b, t, -1))


def fuse_qkv_state_dict(sd: dict, groups=(("to_q", "to_k", "to_v", "to_qkv"),)) -> dict:
    """Reference-layout state dict -> fused layout: wherever `<p>.to_q/k/v
    .weight` (and `.bias`) exist, they are concatenated along the output axis
    into `<p>.to_qkv`. `groups` lists (a, b, c, fused) name tuples; the text
    towers reuse this with their own names. Numerics-preserving."""
    out = dict(sd)
    for key in list(sd):
        for names in groups:
            first, rest, fused = names[0], names[1:-1], names[-1]
            suffix = f".{first}.weight"
            if not key.endswith(suffix) and key != f"{first}.weight":
                continue
            prefix = key[: -len(suffix) + 1] if key.endswith(suffix) else ""
            for kind in ("weight", "bias"):
                parts = [f"{prefix}{n}.{kind}" for n in (first,) + tuple(rest)]
                if all(p in sd for p in parts):
                    out[f"{prefix}{fused}.{kind}"] = torch.cat(
                        [torch.as_tensor(sd[p]) for p in parts], dim=0)
                    for p in parts:
                        del out[p]
    return out
