"""The lucidrains x_transformer encoder with its option set (reference
`ldm/modules/x_transformer.py`, `Encoder` under `TransformerWrapper`).

- norms: LayerNorm, ScaleNorm (eps 1e-5, one scalar g), RMSNorm (eps 1e-8,
  g per channel), or ReZero (no norm; a learned scalar gate on the
  attention branches only: the feed-forward branches are not gated, as in
  the reference, `:467-469`);
- layer layouts: a/f blocks, `macaron` (a leading feed-forward scaled by
  0.5), `sandwich_coef`, `custom_layers` and the PAR layout (`par_ratio`);
- residuals: plain, or `gate_residual` (torch.nn.GRUCell(branch, residual));
- attention: `talking_heads` (head mixing before and after the softmax),
  `sparse_topk` (all but the top k logits masked), `num_mem_kv` learned
  memory keys and values, `on_attn` (a GLU output head), `causal`, query
  and key padding masks, `residual_attn` (the pre-softmax logits carried
  to the next attention), `position_infused_attn` (a sinusoid added to the
  q and k inputs only);
- feed-forward: a GELU MLP or GEGLU;
- the wrapper: an embedding width other than dim (projected), memory
  tokens (the mask padded for them), tied or separate logits, or the
  embeddings.

Not ported, as in the JAX package: entmax15 attention, relative position
bias and rotary (dead in the reference file), and the decoder-side mems
cache. The softmax runs in float32. Parameters in the reference's
`TransformerWrapper` state-dict layout (`attn_layers.layers.<i>.<0 norm |
1 block | 2 residual>`), so a reference checkpoint loads directly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def compute_layer_types(depth: int, cross_attend: bool = False, only_cross: bool = False,
                        macaron: bool = False, custom_layers: Optional[Sequence[str]] = None,
                        par_ratio: Optional[int] = None,
                        sandwich_coef: Optional[int] = None) -> Tuple[str, ...]:
    """The layer-type sequence of `AttentionLayers.__init__` (`:424-452`)."""
    if cross_attend and not only_cross:
        default_block: Tuple[str, ...] = ("a", "c", "f")
    elif cross_attend and only_cross:
        default_block = ("c", "f")
    else:
        default_block = ("a", "f")
    if macaron:
        default_block = ("f",) + default_block
    if custom_layers is not None:
        return tuple(custom_layers)
    if par_ratio is not None:
        par_depth = depth * len(default_block)
        if not 1 < par_ratio <= par_depth:
            raise ValueError("par ratio out of range")
        default_block = tuple(t for t in default_block if t != "f")
        par_attn = par_depth // par_ratio
        depth_cut = par_depth * 2 // 3
        par_width = (depth_cut + depth_cut // par_attn) // par_attn
        if len(default_block) > par_width:
            raise ValueError("default block too large for par_ratio")
        par_block = default_block + ("f",) * (par_width - len(default_block))
        par_head = par_block * par_attn
        return par_head + ("f",) * (par_depth - len(par_head))
    if sandwich_coef is not None:
        if not 0 < sandwich_coef <= depth:
            raise ValueError("sandwich coefficient out of range")
        return (("a",) * sandwich_coef + default_block * (depth - sandwich_coef)
                + ("f",) * sandwich_coef)
    return default_block * depth


def fixed_positional_embedding(dim: int, length: int, device, offset: int = 0) -> torch.Tensor:
    """The shortformer sinusoid table (`:39-46`): (length, dim), [sin | cos]."""
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                                  / dim))
    t = torch.arange(length, dtype=torch.float32, device=device) + offset
    sinusoid = t[:, None] * inv_freq[None, :]
    return torch.cat([sinusoid.sin(), sinusoid.cos()], dim=-1)


class ScaleNorm(nn.Module):
    """x / clamp(|x| dim^-1/2, eps) * g, g one scalar."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale, self.eps = dim ** -0.5, eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * self.scale
        return x / norm.clamp_min(self.eps) * self.g


class RMSNorm(ScaleNorm):
    """ScaleNorm with g per channel and eps 1e-8."""

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__(dim, eps)
        self.g = nn.Parameter(torch.ones(dim))


class Rezero(nn.Module):
    """A branch and its learned scalar gate, zero at init."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.g = nn.Parameter(torch.zeros(1))


class Scale(nn.Module):
    """A branch scaled by a constant (macaron's feed-forward, 0.5)."""

    def __init__(self, value: float, fn: nn.Module):
        super().__init__()
        self.value, self.fn = value, fn


class Residual(nn.Module):
    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return x + residual


class GRUGating(nn.Module):
    """torch.nn.GRUCell with the branch as input and the residual as state."""

    def __init__(self, dim: int):
        super().__init__()
        self.gru = nn.GRUCell(dim, dim)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        return self.gru(x.reshape(-1, d), residual.reshape(-1, d)).reshape(x.shape)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    """net = (Linear + GELU or GEGLU, Dropout, Linear)."""

    def __init__(self, dim: int, mult: int = 4, glu: bool = False):
        super().__init__()
        inner = int(dim * mult)
        project_in = GEGLU(dim, inner) if glu else nn.Sequential(nn.Linear(dim, inner), nn.GELU())
        self.net = nn.Sequential(project_in, nn.Dropout(0.0), nn.Linear(inner, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Attention(nn.Module):
    """Returns (out, pre-softmax logits): the logits feed residual_attn."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, causal: bool = False,
                 talking_heads: bool = False, sparse_topk: Optional[int] = None,
                 num_mem_kv: int = 0, on_attn: bool = False):
        super().__init__()
        inner = dim_head * heads
        self.dim, self.dim_head, self.heads, self.causal = dim, dim_head, heads, causal
        self.talking_heads, self.sparse_topk = talking_heads, sparse_topk
        self.num_mem_kv = num_mem_kv
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        if talking_heads:
            self.pre_softmax_proj = nn.Parameter(torch.randn(heads, heads))
            self.post_softmax_proj = nn.Parameter(torch.randn(heads, heads))
        if num_mem_kv > 0:
            self.mem_k = nn.Parameter(torch.randn(heads, num_mem_kv, dim_head))
            self.mem_v = nn.Parameter(torch.randn(heads, num_mem_kv, dim_head))
        self.to_out = (nn.Sequential(nn.Linear(inner, dim * 2), nn.GLU()) if on_attn
                       else nn.Linear(inner, dim))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None, sinusoidal_emb: bool = False,
                prev_attn: Optional[torch.Tensor] = None):
        b, n, _ = x.shape
        h = self.heads
        kv_input = context if context is not None else x
        q_input, k_input, v_input = x, kv_input, kv_input
        if sinusoidal_emb:  # shortformer: the sinusoid on q and k only, offset 0
            q_input = q_input + fixed_positional_embedding(self.dim, n, x.device)[None]
            k_input = k_input + fixed_positional_embedding(self.dim, k_input.shape[1],
                                                           x.device)[None]
        split = lambda a: a.reshape(b, a.shape[1], h, self.dim_head).transpose(1, 2)
        q, k, v = split(self.to_q(q_input)), split(self.to_k(k_input)), split(self.to_v(v_input))

        input_mask = None
        if mask is not None or context_mask is not None:
            q_mask = mask if mask is not None else torch.ones(b, n, dtype=torch.bool,
                                                              device=x.device)
            k_mask = q_mask if context is None else context_mask
            if k_mask is None:
                k_mask = torch.ones(b, k.shape[2], dtype=torch.bool, device=x.device)
            input_mask = q_mask.bool()[:, None, :, None] & k_mask.bool()[:, None, None, :]
        if self.num_mem_kv > 0:
            k = torch.cat([self.mem_k.expand(b, -1, -1, -1), k], dim=2)
            v = torch.cat([self.mem_v.expand(b, -1, -1, -1), v], dim=2)
            if input_mask is not None:
                input_mask = F.pad(input_mask, (self.num_mem_kv, 0), value=True)

        dots = torch.matmul(q, k.transpose(-1, -2)).to(x.dtype) * self.dim_head ** -0.5
        mask_value = -torch.finfo(dots.dtype).max
        if prev_attn is not None:
            dots = dots + prev_attn
        pre_softmax_attn = dots
        if self.talking_heads:
            dots = torch.einsum("bhij,hk->bkij", dots, self.pre_softmax_proj)
        if input_mask is not None:
            dots = dots.masked_fill(~input_mask, mask_value)
        if self.causal:
            i, j = dots.shape[-2:]
            causal_mask = (torch.arange(i, device=x.device)[:, None]
                           < torch.arange(j, device=x.device)[None, :] - (j - i))
            dots = dots.masked_fill(causal_mask, mask_value)
        if self.sparse_topk is not None and self.sparse_topk < dots.shape[-1]:
            vk = dots.topk(self.sparse_topk, dim=-1).values[..., -1:]
            dots = dots.masked_fill(dots < vk, mask_value)
        attn = torch.softmax(dots.to(torch.float32), dim=-1).to(v.dtype)
        if self.talking_heads:
            attn = torch.einsum("bhij,hk->bkij", attn, self.post_softmax_proj)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, -1)
        return self.to_out(out), pre_softmax_attn


class XTransformerEncoder(nn.Module):
    """`AttentionLayers` / `Encoder` (`:370-545`)."""

    def __init__(self, dim: int, depth: int, heads: int = 8, dim_head: int = 64,
                 causal: bool = False, cross_attend: bool = False, only_cross: bool = False,
                 use_scalenorm: bool = False, use_rmsnorm: bool = False, use_rezero: bool = False,
                 position_infused_attn: bool = False,
                 custom_layers: Optional[Sequence[str]] = None,
                 sandwich_coef: Optional[int] = None, par_ratio: Optional[int] = None,
                 residual_attn: bool = False, cross_residual_attn: bool = False,
                 macaron: bool = False, pre_norm: bool = True, gate_residual: bool = False,
                 talking_heads: bool = False, sparse_topk: Optional[int] = None,
                 num_mem_kv: int = 0, on_attn: bool = False, ff_mult: int = 4,
                 ff_glu: bool = False):
        super().__init__()
        # the flags the forward and `convert.xtransformer_from_jax` read
        self.dim, self.use_scalenorm, self.use_rmsnorm = dim, use_scalenorm, use_rmsnorm
        self.use_rezero, self.macaron, self.pre_norm = use_rezero, macaron, pre_norm
        self.position_infused_attn, self.residual_attn = position_infused_attn, residual_attn
        self.cross_residual_attn = cross_residual_attn
        self.on_attn, self.ff_glu = on_attn, ff_glu
        self.layer_types = compute_layer_types(depth, cross_attend, only_cross, macaron,
                                               custom_layers, par_ratio, sandwich_coef)
        layers = []
        for t in self.layer_types:
            if use_rezero:
                norm = nn.Identity()
            elif use_rmsnorm:
                norm = RMSNorm(dim)
            elif use_scalenorm:
                norm = ScaleNorm(dim)
            else:
                norm = nn.LayerNorm(dim, eps=1e-5)
            if t in ("a", "c"):
                block = Attention(dim, dim_head, heads, causal=causal and t == "a",
                                  talking_heads=talking_heads, sparse_topk=sparse_topk,
                                  num_mem_kv=num_mem_kv, on_attn=on_attn)
                if use_rezero:
                    block = Rezero(block)
            elif t == "f":
                block = FeedForward(dim, ff_mult, ff_glu)
                if macaron:
                    block = Scale(0.5, block)
            else:
                raise ValueError(f"unknown layer type {t!r}")
            layers.append(nn.ModuleList([norm, block,
                                         GRUGating(dim) if gate_residual else Residual()]))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        prev_attn = prev_cross_attn = None
        for i, (t, (norm, block, residual_fn)) in enumerate(zip(self.layer_types, self.layers)):
            residual = x
            h = norm(x) if self.pre_norm else x
            if t in ("a", "c"):
                attn = block.fn if self.use_rezero else block
                if t == "a":
                    out, logits = attn(h, mask=mask, sinusoidal_emb=self.position_infused_attn,
                                       prev_attn=prev_attn)
                    if self.residual_attn:
                        prev_attn = logits
                else:
                    out, logits = attn(h, context=context, mask=mask,
                                       context_mask=context_mask, prev_attn=prev_cross_attn)
                    if self.cross_residual_attn:
                        prev_cross_attn = logits
                if self.use_rezero:  # the attention branches only
                    out = out * block.g
            else:
                out = block.fn(h) * block.value if self.macaron else block(h)
            x = residual_fn(out, residual)
            if not self.pre_norm and i != len(self.layers) - 1:
                x = norm(x)
        return x


class XTransformerWrapper(nn.Module):
    """`TransformerWrapper` (`:548-630`): ids (B, N) [+ mask (B, N)] ->
    embeddings (B, N, dim), or logits (B, N, num_tokens)."""

    def __init__(self, num_tokens: int, max_seq_len: int, encoder: XTransformerEncoder,
                 emb_dim: Optional[int] = None, num_memory_tokens: int = 0,
                 tie_embedding: bool = False, use_pos_emb: bool = True,
                 return_embeddings: bool = True):
        super().__init__()
        dim = encoder.dim
        emb_dim = emb_dim if emb_dim is not None else dim
        self.num_memory_tokens, self.tie_embedding = num_memory_tokens, tie_embedding
        self.return_embeddings = return_embeddings
        self.token_emb = nn.Embedding(num_tokens, emb_dim)
        self.pos_emb = None
        if use_pos_emb and not encoder.position_infused_attn:
            self.pos_emb = nn.Module()
            self.pos_emb.emb = nn.Embedding(max_seq_len, emb_dim)
        self.project_emb = nn.Linear(emb_dim, dim) if emb_dim != dim else None
        self.attn_layers = encoder
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        if num_memory_tokens > 0:
            self.memory_tokens = nn.Parameter(torch.randn(num_memory_tokens, dim))
        self.to_logits = (nn.Linear(dim, num_tokens)
                          if not return_embeddings and not tie_embedding else None)

    def forward(self, input_ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n = input_ids.shape
        x = self.token_emb(input_ids.long())
        if self.pos_emb is not None:
            x = x + self.pos_emb.emb.weight[None, :n]
        if self.project_emb is not None:
            x = self.project_emb(x)
        if self.num_memory_tokens > 0:
            x = torch.cat([self.memory_tokens.expand(b, -1, -1), x], dim=1)
            if mask is not None:
                mask = F.pad(mask.bool(), (self.num_memory_tokens, 0), value=True)
        x = self.norm(self.attn_layers(x, mask=mask))[:, self.num_memory_tokens:]
        if self.return_embeddings:
            return x
        if self.tie_embedding:
            return x @ self.token_emb.weight.T
        return self.to_logits(x)
