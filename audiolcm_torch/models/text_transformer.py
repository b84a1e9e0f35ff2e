"""Trainable from-scratch text encoder (the BERTEmbedder slot, reference
`ldm/modules/encoders/modules.py:54-141`): a token embedding, learned
absolute positions and a pre-LN transformer (exact GELU MLP), then a final
LayerNorm. The shipped configs do not use it; the vanilla path is what the
older configs exercise. The full lucidrains option set is
`models/x_transformer_zoo.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.nn.attention import MultiHeadSelfAttention


class _Layer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_mult: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadSelfAttention(dim, num_heads, dim // num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ff_in = nn.Linear(dim, dim * mlp_mult)
        self.ff_out = nn.Linear(dim * mlp_mult, dim)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = h + self.attn(self.norm1(h))
        return h + self.ff_out(F.gelu(self.ff_in(self.norm2(h))))


class TransformerTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 30522, max_seq_len: int = 77, dim: int = 1280,
                 depth: int = 8, num_heads: int = 8, mlp_mult: int = 4):
        super().__init__()
        self.token_emb = nn.Embedding(vocab_size, dim)
        self.pos_emb = nn.Parameter(torch.zeros(max_seq_len, dim))
        nn.init.normal_(self.pos_emb, std=0.02)
        self.layers = nn.ModuleList([_Layer(dim, num_heads, mlp_mult) for _ in range(depth)])
        self.final_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, L) token ids -> (B, L, dim)."""
        h = self.token_emb(input_ids.long()) + self.pos_emb[None, :input_ids.shape[1]]
        for layer in self.layers:
            h = layer(h)
        return self.final_norm(h)
