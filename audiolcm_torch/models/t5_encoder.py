"""T5-v1.1 encoder tower (structured-caption branch of the conditioner).

HF `T5EncoderModel` semantics for google/t5-v1_1-large: RMSNorm eps 1e-6,
gated-GELU feed-forward with the tanh approximation, no attention-logit
scaling, relative position bias computed once (block 0) and shared by all
layers. FrozenCLAPFLANEmbedder passes no attention mask; a given
`attention_mask` becomes a -1e9 bias on the padded keys' logits. Parameters
use the HF key layout.

fuse_proj=True runs Q/K/V as one matmul (`SelfAttention.qkv`) and wi_0/wi_1
as one (`DenseReluDense.wi`); see `fuse_t5_state_dict`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.nn.attention import fuse_qkv_state_dict, padding_bias


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


def relative_position_buckets(qlen: int, klen: int, num_buckets: int = 32,
                              max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket matrix, (qlen, klen) int64."""
    rel = np.arange(klen)[None, :] - np.arange(qlen)[:, None]
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    arel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(arel, 1) / max_exact) / np.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return out + np.where(arel < max_exact, arel, large)


@functools.lru_cache(maxsize=None)
def bucket_table(qlen: int, klen: int, num_buckets: int, max_distance: int,
                 device: torch.device) -> torch.Tensor:
    """`relative_position_buckets` as an int64 tensor on `device`, built
    once per shape and device: a forward copies nothing from the host, so
    it can be captured in a CUDA graph. Built outside inference mode, so
    that a forward under autograd may save it."""
    with torch.inference_mode(False):
        return torch.from_numpy(relative_position_buckets(qlen, klen, num_buckets,
                                                          max_distance)).to(device)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        # a bf16 weight promotes to f32 inside the multiply: no cast launch
        return (y * self.weight).to(self.weight.dtype)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, fuse_proj: bool, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.fuse_proj = fuse_proj
        if fuse_proj:
            self.qkv = nn.Linear(cfg.d_model, 3 * inner, bias=False)
        else:
            self.q, self.k, self.v = (nn.Linear(cfg.d_model, inner, bias=False) for _ in range(3))
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)


class _AttnLayer(nn.Module):
    def __init__(self, cfg: T5Config, fuse_proj: bool, has_bias: bool):
        super().__init__()
        self.SelfAttention = _SelfAttention(cfg, fuse_proj, has_bias)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class _DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config, fuse_proj: bool):
        super().__init__()
        self.fuse_proj = fuse_proj
        if fuse_proj:
            self.wi = nn.Linear(cfg.d_model, 2 * cfg.d_ff, bias=False)
        else:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.fuse_proj:
            g, lin = self.wi(h).chunk(2, dim=-1)
        else:
            g, lin = self.wi_0(h), self.wi_1(h)
        return self.wo(F.gelu(g, approximate="tanh") * lin)


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5Config, fuse_proj: bool):
        super().__init__()
        self.DenseReluDense = _DenseGatedGelu(cfg, fuse_proj)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Layer(nn.Module):
    def __init__(self, cfg: T5Config, fuse_proj: bool = False, has_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        self.layer = nn.ModuleList([_AttnLayer(cfg, fuse_proj, has_bias), _FFLayer(cfg, fuse_proj)])

    def forward(self, x: torch.Tensor, pos_bias: torch.Tensor,
                mask_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        attn = self.layer[0].SelfAttention
        h = self.layer[0].layer_norm(x)
        split = lambda a: a.reshape(b, t, cfg.num_heads, cfg.d_kv).transpose(1, 2)
        if attn.fuse_proj:
            q, k, v = (split(a) for a in attn.qkv(h).chunk(3, dim=-1))
        else:
            q, k, v = split(attn.q(h)), split(attn.k(h)), split(attn.v(h))
        # f32 logits from bf16 q / k, as JAX's preferred_element_type=float32
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + pos_bias
        if mask_bias is not None:
            logits = logits + mask_bias
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, t, -1)
        x = x + attn.o(out)
        ff = self.layer[1]
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config, fuse_proj: bool):
        super().__init__()
        self.block = nn.ModuleList(
            [T5Layer(cfg, fuse_proj, has_bias=(i == 0)) for i in range(cfg.num_layers)])
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """input_ids (B, L) [+ attention_mask (B, L), 1 = token, 0 = padding]
    -> last_hidden_state (B, L, d_model)."""

    def __init__(self, config: T5Config = T5Config(), fuse_proj: bool = False):
        super().__init__()
        self.config, self.fuse_proj = config, fuse_proj
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = _Stack(config, fuse_proj)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        t = input_ids.shape[1]
        h = self.shared(input_ids)
        rel = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        buckets = bucket_table(t, t, cfg.relative_attention_num_buckets,
                               cfg.relative_attention_max_distance, rel.device)
        pos_bias = rel[buckets].permute(2, 0, 1)[None].to(torch.float32)
        mask_bias = padding_bias(attention_mask)
        for block in self.encoder.block:
            h = block(h, pos_bias, mask_bias)
        return self.encoder.final_layer_norm(h)


def fuse_t5_state_dict(sd: dict) -> dict:
    """Reference layout -> fuse_proj layout: q/k/v -> qkv, wi_0/wi_1 -> wi."""
    return fuse_qkv_state_dict(sd, (("q", "k", "v", "qkv"), ("wi_0", "wi_1", "wi")))
