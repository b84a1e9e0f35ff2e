"""Order-conditioned DiT variants for temporal-order structured captions.

Reference `concatDiT.py:306-502` (ConcatOrderDiT / ConcatOrderDiT2). The
reference walks python lists of token ids per batch element at forward
time; here the host turns token ids and per-sample order lists into
integer tensors of a fixed shape (`compute_order_indices`,
`compute_order_insertion`), and the model adds or gathers order
embeddings with one lookup.

Token ids follow the reference's BERT tokenizer (`concatDiT.py:363`):
101 <start>, 102 <eos>, 0 <pad>, 1064 the '|' separator.

Parameters in the reference layout: ConcatDiT's plus `order_embedding`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from audiolcm_torch.models.dit import ConcatDiT

SPECIAL_IDS = (101, 102, 0, 1064)
SEP_ID = 1064


def compute_order_indices(token_ids: np.ndarray, orders: List[List[int]]) -> np.ndarray:
    """(B, L) token ids + per-sample order lists -> (B, L) int32 order index
    per token (-1 for specials and pad). Tokens between '|' separators
    share the current object's order id (`add_order_embedding`)."""
    b, l = token_ids.shape
    out = np.full((b, l), -1, dtype=np.int32)
    for bi in range(b):
        cur = 0
        orderl = orders[bi]
        for i in range(l):
            tid = int(token_ids[bi, i])
            if tid in SPECIAL_IDS:
                if tid == SEP_ID:
                    cur += 1
                continue
            if cur < len(orderl):
                out[bi, i] = orderl[cur]
    return out


def compute_order_insertion(token_ids: np.ndarray, orders: List[List[int]], max_objs: int = 10,
                            pad_order: int = 100) -> Tuple[np.ndarray, np.ndarray]:
    """ConcatOrderDiT2's layout: an order token is inserted at each '|'.

    Returns (src, order_id), both (B, L + max_objs) int32: src[b, j] >= 0
    gathers caption token src[b, j]; src[b, j] == -1 takes the order
    embedding order_id[b, j]."""
    b, l = token_ids.shape
    out_len = l + max_objs
    src = np.full((b, out_len), -1, dtype=np.int32)
    oid = np.full((b, out_len), pad_order, dtype=np.int32)
    for bi in range(b):
        orderl = list(orders[bi])
        j = 0
        seen = 0
        for i in range(l):
            if int(token_ids[bi, i]) == SEP_ID and seen < len(orderl):
                src[bi, j] = -1
                oid[bi, j] = orderl[seen]
                seen += 1
                j += 1
            src[bi, j] = i
            j += 1
        while j < out_len:
            src[bi, j] = -1
            oid[bi, j] = pad_order
            j += 1
    return src, oid


class ConcatOrderDiT(ConcatDiT):
    """The order embedding added to the caption tokens' embeddings."""

    def __init__(self, in_channels: int = 20, context_dim: int = 1024, hidden_size: int = 576,
                 depth: int = 4, num_heads: int = 8, max_len: int = 1000, num_orders: int = 100):
        super().__init__(in_channels, context_dim, hidden_size, depth, num_heads, max_len)
        self.order_embedding = torch.nn.Embedding(num_orders, hidden_size)

    def forward(self, x: torch.Tensor, t: torch.Tensor, token_embedding: torch.Tensor,
                order_index: torch.Tensor, w_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, in_ch), t (B,), token_embedding (B, L, context_dim),
        order_index (B, L) with -1 where no order is added -> eps."""
        c = self.c_embedder(token_embedding)
        order_index = order_index.long()
        # clamped before the lookup: -1 never reaches the embedding
        emb = self.order_embedding(order_index.clamp_min(0))
        c = c + torch.where((order_index >= 0)[..., None], emb, 0.0)
        return self.backbone(x, t, w_cond, c)


class ConcatOrderDiT2(ConcatDiT):
    """Order tokens inserted into the caption sequence: the condition is
    L + max_objs tokens long."""

    def __init__(self, in_channels: int = 20, context_dim: int = 1024, hidden_size: int = 576,
                 depth: int = 4, num_heads: int = 8, max_len: int = 1000, num_orders: int = 101):
        super().__init__(in_channels, context_dim, hidden_size, depth, num_heads, max_len)
        self.order_embedding = torch.nn.Embedding(num_orders, hidden_size)

    def forward(self, x: torch.Tensor, t: torch.Tensor, token_embedding: torch.Tensor,
                src: torch.Tensor, order_id: torch.Tensor,
                w_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """src, order_id (B, L + max_objs) from `compute_order_insertion`."""
        c = self.c_embedder(token_embedding)
        src = src.long()
        index = src.clamp_min(0)[..., None].expand(-1, -1, c.shape[-1])
        gathered = torch.gather(c, 1, index)
        c = torch.where((src >= 0)[..., None], gathered, self.order_embedding(order_id.long()))
        return self.backbone(x, t, w_cond, c)
