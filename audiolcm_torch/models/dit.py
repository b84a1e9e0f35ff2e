"""ConcatDiT2MLP denoiser (the "U-Net" slot of the latent diffusion).

Reference `concatDiT.py:238-304`, the live backbone of configs/audiolcm.yaml:

  seq = [timestep token | CLAP-half cond tokens | T5-half cond tokens | latent frames]
  + learned absolute position embedding, then `depth` blocks of
  (GroupNorm -> 1x1 in -> [self-attn, self-attn, conv-GEGLU-FF] -> 1x1 out
  -> residual), slice off the condition prefix, GroupNorm(16) + 1x1 head.

`ConcatDiT` (`concatDiT.py:173-236`) is the same backbone with one
condition embedder over the whole context. Neither it nor the order DiTs
built on it (`models/order_dit.py`) has the flash or fused-QKV knob: the
reference and the JAX package run them on einsum attention only.

Public layout (B, T, C); parameters in the reference state-dict layout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.nn.attention import MultiHeadSelfAttention
from audiolcm_torch.nn.convff import Conv1dGEGLUFeedForward
from audiolcm_torch.nn.embeddings import timestep_embedding


def linear_promoted(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """Linear in the promoted dtype of input and weight (the JAX Dense rule:
    an f32 sinusoid through bf16 weights runs in f32)."""
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def conv1x1(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """A (C_out, C_in, 1) Conv1d applied to channels-last (B, T, C_in)."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


def group_norm_cl(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    return norm(x.transpose(1, 2)).transpose(1, 2)


class TimestepEmbedder(nn.Module):
    """sinusoidal(256) (+ proj_w(w_cond)) -> MLP(hidden)."""

    def __init__(self, hidden_size: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = nn.Sequential(nn.Linear(freq_dim, hidden_size), nn.SiLU(),
                                 nn.Linear(hidden_size, hidden_size))
        self.proj_w = nn.Linear(freq_dim, freq_dim, bias=False)

    def forward(self, t: torch.Tensor, w_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = timestep_embedding(t, self.freq_dim)
        if w_cond is not None:
            h = h + linear_promoted(w_cond, self.proj_w)
        h = F.silu(linear_promoted(h, self.mlp[0]))
        return linear_promoted(h, self.mlp[2])


class ConditionEmbedder(nn.Module):
    """Linear -> tanh-GELU -> Linear -> LayerNorm."""

    def __init__(self, context_dim: int, hidden_size: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(context_dim, hidden_size), nn.GELU(approximate="tanh"),
                                 nn.Linear(hidden_size, hidden_size),
                                 nn.LayerNorm(hidden_size, eps=1e-5))

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.mlp(c)


class BasicTransformerBlock(nn.Module):
    """Two self-attentions + conv-GEGLU FF, pre-LN residuals."""

    def __init__(self, dim: int, num_heads: int, use_flash: bool = False,
                 fuse_qkv: bool = False):
        super().__init__()
        head_dim = dim // num_heads
        self.attn1 = MultiHeadSelfAttention(dim, num_heads, head_dim, use_flash, fuse_qkv)
        self.attn2 = MultiHeadSelfAttention(dim, num_heads, head_dim, use_flash, fuse_qkv)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = Conv1dGEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x))
        return x + self.ff(self.norm3(x))


class TemporalTransformer(nn.Module):
    """GroupNorm(32) -> 1x1 -> block -> 1x1 -> + x."""

    def __init__(self, dim: int, num_heads: int, use_flash: bool = False,
                 fuse_qkv: bool = False):
        super().__init__()
        self.norm = nn.GroupNorm(32, dim, eps=1e-6)
        self.proj_in = nn.Conv1d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, num_heads, use_flash, fuse_qkv)])
        self.proj_out = nn.Conv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv1x1(group_norm_cl(x, self.norm), self.proj_in)
        for block in self.transformer_blocks:
            h = block(h)
        return conv1x1(h, self.proj_out) + x


class _FinalLayer(nn.Module):
    def __init__(self, hidden_size: int, out_channels: int):
        super().__init__()
        self.norm_final = nn.GroupNorm(16, hidden_size, eps=1e-5)
        self.conv1d = nn.Conv1d(hidden_size, out_channels, 1)


class _ConcatBackbone(nn.Module):
    """What the concat DiTs share: the timestep embedder, proj_in, the
    positions, the blocks and the head. A subclass adds its condition
    embedders and calls `backbone`."""

    def __init__(self, in_channels: int, context_dim: int, hidden_size: int, depth: int,
                 num_heads: int, max_len: int, out_channels: int, use_flash: bool = False,
                 fuse_qkv: bool = False):
        super().__init__()
        self.in_channels, self.context_dim = in_channels, context_dim
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.proj_in = nn.Conv1d(in_channels, hidden_size, 5, padding=2)
        self.pos_emb = nn.Embedding(max_len, hidden_size)
        self.blocks = nn.ModuleList([
            TemporalTransformer(hidden_size, num_heads, use_flash, fuse_qkv)
            for _ in range(depth)])
        self.final_layer = _FinalLayer(hidden_size, out_channels)

    def backbone(self, x: torch.Tensor, t: torch.Tensor, w_cond: Optional[torch.Tensor],
                 cond: torch.Tensor) -> torch.Tensor:
        """[timestep token | condition tokens | proj_in(x)] + positions ->
        blocks -> the latent frames through the final GroupNorm and head."""
        t_tok = self.t_embedder(t, w_cond)[:, None, :]
        h = self.proj_in(x.transpose(1, 2)).transpose(1, 2)
        # cast the f32 timestep token and the condition tokens to the latent
        # stream's dtype so a bf16 stream stays bf16
        h = torch.cat([t_tok.to(h.dtype), cond.to(h.dtype), h], dim=1)
        h = h + self.pos_emb.weight[None, :h.shape[1]]
        for block in self.blocks:
            h = block(h)
        h = h[:, cond.shape[1] + 1:]
        h = group_norm_cl(h, self.final_layer.norm_final)
        return conv1x1(h, self.final_layer.conv1d)


class ConcatDiT2MLP(_ConcatBackbone):
    """Dual condition embedders over the CLAP/T5 halves of the context, and
    with `llm_context_dim` a third over a caption LLM's hidden states
    (`models/moe_llm.py`), whose tokens follow the T5 half's in the prefix.

    Shipped config: in_channels=20, context_dim=1024, hidden_size=576,
    num_heads=8, depth=4, max_len=1000, no third embedder."""

    def __init__(self, in_channels: int = 20, context_dim: int = 1024, hidden_size: int = 576,
                 depth: int = 4, num_heads: int = 8, max_len: int = 1000,
                 use_flash: bool = False, fuse_qkv: bool = False,
                 out_channels: Optional[int] = None, llm_context_dim: Optional[int] = None):
        super().__init__(in_channels, context_dim, hidden_size, depth, num_heads, max_len,
                         out_channels or in_channels, use_flash, fuse_qkv)
        self.fuse_qkv = fuse_qkv
        self.c1_embedder = ConditionEmbedder(context_dim, hidden_size)
        self.c2_embedder = ConditionEmbedder(context_dim, hidden_size)
        if llm_context_dim is not None:
            self.c3_embedder = ConditionEmbedder(llm_context_dim, hidden_size)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                w_cond: Optional[torch.Tensor] = None,
                llm_context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, in_ch), t (B,), context (B, 2*Lc, context_dim), llm_context
        (B, L, llm_context_dim) with the third embedder -> eps (B, T, out_ch)."""
        if (llm_context is None) == hasattr(self, "c3_embedder"):
            raise ValueError("llm_context is given exactly when the DiT has a third embedder "
                             "(llm_context_dim)")
        c1, c2 = context.chunk(2, dim=1)
        cond = [self.c1_embedder(c1), self.c2_embedder(c2)]
        if llm_context is not None:
            cond.append(self.c3_embedder(llm_context))
        return self.backbone(x, t, w_cond, torch.cat(cond, dim=1))


class ConcatDiT(_ConcatBackbone):
    """One condition embedder over the whole context (B, Lc, context_dim)."""

    def __init__(self, in_channels: int = 20, context_dim: int = 1024, hidden_size: int = 576,
                 depth: int = 4, num_heads: int = 8, max_len: int = 1000):
        super().__init__(in_channels, context_dim, hidden_size, depth, num_heads, max_len,
                         in_channels)
        self.c_embedder = ConditionEmbedder(context_dim, hidden_size)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                w_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, in_ch), t (B,), context (B, Lc, context_dim) -> eps (B, T, in_ch)."""
        return self.backbone(x, t, w_cond, self.c_embedder(context))
