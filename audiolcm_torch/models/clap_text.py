"""CLAP text tower: BERT-base encoder + residual-MLP projection to 1024-d.

Reference `CLAP/clap.py` TextEncoder (HF bert-base-uncased + Projection) as
FrozenCLAPFLANEmbedder uses it: the projection applies to the full
last_hidden_state (77 tokens) and no attention mask is passed, so padding
tokens are attended. Other callers (the LAION CLAP's text towers) pass an
`attention_mask`, which becomes a -1e9 bias on the padded keys' logits. erf GELU; LayerNorm eps 1e-12 in BERT, 1e-5 in the
projection. Parameters use the HF BertModel key layout under `base.`.

fuse_proj=True runs Q/K/V as one matmul (`attention.self.qkv`; see
`fuse_bert_state_dict`), numerics-preserving.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.nn.attention import dot_product_attention, fuse_qkv_state_dict, padding_bias


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


class _SelfAttention(nn.Module):
    def __init__(self, d: int, fuse_proj: bool):
        super().__init__()
        self.fuse_proj = fuse_proj
        if fuse_proj:
            self.qkv = nn.Linear(d, 3 * d)
        else:
            self.query, self.key, self.value = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x):
        if self.fuse_proj:
            return self.qkv(x).chunk(3, dim=-1)
        return self.query(x), self.key(x), self.value(x)


class _DenseNorm(nn.Module):
    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)


class _Attention(nn.Module):
    def __init__(self, cfg: BertConfig, fuse_proj: bool):
        super().__init__()
        self.self = _SelfAttention(cfg.hidden_size, fuse_proj)
        self.output = _DenseNorm(cfg.hidden_size, cfg.hidden_size, cfg.layer_norm_eps)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, fuse_proj: bool = False):
        super().__init__()
        self.cfg = cfg
        self.attention = _Attention(cfg, fuse_proj)
        self.intermediate = _Intermediate(cfg)
        self.output = _DenseNorm(cfg.intermediate_size, cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mask_bias: `padding_bias` of the attention mask, or None."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.hidden_size // cfg.num_heads
        split = lambda a: a.reshape(b, t, cfg.num_heads, hd).transpose(1, 2)
        q, k, v = self.attention.self(x)
        attn = dot_product_attention(split(q), split(k), split(v), hd**-0.5, mask_bias)
        attn = attn.transpose(1, 2).reshape(b, t, cfg.hidden_size)
        ao = self.attention.output
        x = ao.LayerNorm(x + ao.dense(attn))
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        h = (self.word_embeddings(ids) + self.position_embeddings.weight[None, :ids.shape[1]]
             + self.token_type_embeddings.weight[0][None, None])
        return self.LayerNorm(h)


class _Layers(nn.Module):
    def __init__(self, cfg: BertConfig, fuse_proj: bool):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg, fuse_proj) for _ in range(cfg.num_layers)])


class BertEncoder(nn.Module):
    """input_ids (B, L) [+ attention_mask (B, L), 1 = token, 0 = padding]
    -> last_hidden_state (B, L, hidden)."""

    def __init__(self, config: BertConfig = BertConfig(), fuse_proj: bool = False):
        super().__init__()
        self.embeddings = _Embeddings(config)
        self.encoder = _Layers(config, fuse_proj)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.embeddings(input_ids)
        mask_bias = padding_bias(attention_mask)
        for layer in self.encoder.layer:
            h = layer(h, mask_bias)
        return h


class Projection(nn.Module):
    """LN(linear1(x) + linear2(gelu(linear1(x))))."""

    def __init__(self, d_in: int, d_out: int = 1024):
        super().__init__()
        self.linear1 = nn.Linear(d_in, d_out, bias=False)
        self.linear2 = nn.Linear(d_out, d_out, bias=False)
        self.layer_norm = nn.LayerNorm(d_out, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self.linear1(x)
        return self.layer_norm(e1 + self.linear2(F.gelu(e1)))


class ClapTextEncoder(nn.Module):
    """token ids (B, L) -> per-token projection (B, L, d_proj)."""

    def __init__(self, config: BertConfig = BertConfig(), d_proj: int = 1024,
                 fuse_proj: bool = False):
        super().__init__()
        self.config, self.fuse_proj = config, fuse_proj
        self.base = BertEncoder(config, fuse_proj)
        self.projection = Projection(config.hidden_size, d_proj)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.projection(self.base(input_ids, attention_mask))


def fuse_bert_state_dict(sd: dict) -> dict:
    """Reference layout -> fuse_proj layout: query/key/value -> qkv."""
    return fuse_qkv_state_dict(sd, (("query", "key", "value", "qkv"),))
