"""TxtFlagLargeDiT: the LLaMA-style DiT backbone (reference
`ldm/modules/diffusionmodules/flag_large_dit.py:527-654`).

  * tokens = a linear projection of the latent frames; rotary positions
    over interleaved pairs (x[..., 0::2], x[..., 1::2]), applied in f32,
    from tables computed in f64 over max_len and cast to f32;
  * each block: RMSNorm -> self-attention (optionally fewer KV heads,
    repeated per head group) with a tanh-gated cross-attention branch in
    which the rotated queries attend to the caption's un-rotated keys and
    values, RMSNorm -> SwiGLU feed-forward (hidden width 8d/3 rounded up
    to multiple_of);
  * adaLN: a 6-way shift / scale / gate modulation from the timestep
    embedding plus the pooled caption's; the final layer is a LayerNorm
    without affine parameters, a 2-way modulation and a linear head.

The modulations, the head and the gates are zero at init, so a fresh
model returns 0. Every attention mask of the reference's call path is all
ones, so none is applied. Channels-last (B, T, C). Parameter names follow
the JAX package's tree (`flag_dit_from_jax` in `audiolcm_torch/convert.py`
carries it over).

Two routes, one set of weights:

  * the parity route (`use_flash=False`, the default, which the trainers and
    the JAX parity tests run): rotary and qk-norm as the JAX package has
    them, q and k left in f32, each attention as f32 matmuls over
    materialised (B, H, T, Tk) logits;
  * the serving route (`use_flash=True`, what `api.build_pipeline(...,
    use_flash=True)` and the teacher path serve in bf16): qk-norm and the
    rotary computed in f32 and rounded once to the stream's dtype, then the
    self-attention and the caption branch each as one launch of the flash
    kernel (`nn/flash_attention.py`, K3; its plain version on the CPU), the
    branch with its own key length, and the two outputs summed with
    tanh(gate) in one rounding. No logits reach memory.

Inside `caption_memo` (the teacher's sampler opens it) either route
computes what it reads of the caption alone once per context tensor, not
at every step.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.models.dit import linear_promoted
from audiolcm_torch.models.t5_encoder import RMSNorm
from audiolcm_torch.nn.embeddings import timestep_embedding
from audiolcm_torch.nn.flash_attention import flash_attention


def precompute_rotary(head_dim: int, max_len: int, theta: float = 10000.0):
    """(max_len, head_dim // 2) cos and sin tables in float32 (LLaMA's
    freqs_cis, computed in float64)."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2)[: head_dim // 2] / head_dim))
    angles = np.outer(np.arange(max_len), freqs)
    return (torch.from_numpy(np.cos(angles).astype(np.float32)),
            torch.from_numpy(np.sin(angles).astype(np.float32)))


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D) -> float32, each consecutive pair rotated."""
    t = x.shape[1]
    x = x.to(torch.float32)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    cos, sin = cos[None, :t, None, :], sin[None, :t, None, :]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, H, T, D) float32 q against k, v of any float dtype; f32 softmax."""
    logits = torch.matmul(q, k.to(torch.float32).transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(logits, dim=-1), v.to(torch.float32))


def norm_f32(a: torch.Tensor, norm: Optional[nn.LayerNorm]) -> torch.Tensor:
    """a in f32 through the qk-norm `norm` (over the whole vector) when given."""
    x = a.to(torch.float32)
    if norm is None:
        return x
    return F.layer_norm(x, x.shape[-1:], norm.weight.to(torch.float32),
                        norm.bias.to(torch.float32), norm.eps)


def rotate_rounded(a: torch.Tensor, norm: Optional[nn.LayerNorm], n: int,
                   cis: torch.Tensor) -> torch.Tensor:
    """The serving route's q or k: a (B, T, n*hd) projection -> (B, T, n, hd)
    in a's dtype, its qk-norm (`norm_f32`) and its rotary (cis: (>= T, hd/2)
    complex64 cos + i sin) in f32, rounded once."""
    b, t, _ = a.shape
    x = torch.view_as_complex(norm_f32(a, norm).reshape(b, t, n, -1, 2)) * cis[None, :t, None, :]
    return torch.view_as_real(x).reshape(b, t, n, -1).to(a.dtype)


class FlagAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, n_kv_heads: Optional[int] = None,
                 y_dim: int = 0, qk_norm: bool = False, use_flash: bool = False):
        super().__init__()
        h, kvh = num_heads, n_kv_heads or num_heads
        if h % kvh:
            raise ValueError(f"num_heads {h} is not a multiple of n_kv_heads {kvh}")
        hd = dim // h
        self.h, self.kvh, self.hd, self.y_dim, self.qk_norm = h, kvh, hd, y_dim, qk_norm
        self.use_flash = use_flash
        self.wq = nn.Linear(dim, h * hd, bias=False)
        self.wk = nn.Linear(dim, kvh * hd, bias=False)
        self.wv = nn.Linear(dim, kvh * hd, bias=False)
        if qk_norm:
            self.q_norm = nn.LayerNorm(h * hd, eps=1e-5)
            self.k_norm = nn.LayerNorm(kvh * hd, eps=1e-5)
        if y_dim > 0:
            self.wk_y = nn.Linear(y_dim, kvh * hd, bias=False)
            self.wv_y = nn.Linear(y_dim, kvh * hd, bias=False)
            if qk_norm:
                self.ky_norm = nn.LayerNorm(kvh * hd, eps=1e-5)
            self.gate = nn.Parameter(torch.zeros(h))
        self.wo = nn.Linear(h * hd, dim, bias=False)

    def _heads(self, a: torch.Tensor, n: int) -> torch.Tensor:
        """(B, T, n*hd) -> (B, T, H, hd), KV heads repeated per group."""
        a = a.reshape(a.shape[0], a.shape[1], n, self.hd)
        return a if n == self.h else a.repeat_interleave(self.h // n, dim=2)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                cis: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The parity route over the normed caption y; the serving route over
        its keys and values y = `caption_kv(...)`."""
        if self.use_flash:
            return self._served(x, cis, y)
        b, t, _ = x.shape
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        if self.qk_norm:  # over the whole h*hd vector, before the head split
            q, k = self.q_norm(q), self.k_norm(k)
        q = apply_rotary(q.reshape(b, t, self.h, self.hd), cos, sin)
        k = apply_rotary(k.reshape(b, t, self.kvh, self.hd), cos, sin)
        if self.kvh != self.h:
            k = k.repeat_interleave(self.h // self.kvh, dim=2)
        v = self._heads(v, self.kvh)
        bhtd = lambda a: a.transpose(1, 2)
        scale = self.hd ** -0.5
        out = _attend(bhtd(q), bhtd(k), bhtd(v), scale)
        if self.y_dim > 0 and y is not None:
            yk = self.wk_y(y)
            if self.qk_norm:
                yk = self.ky_norm(yk)
            yk, yv = self._heads(yk, self.kvh), self._heads(self.wv_y(y), self.kvh)
            yout = _attend(bhtd(q), bhtd(yk), bhtd(yv), scale)
            out = out + torch.tanh(self.gate)[None, :, None, None] * yout
        return self.wo(out.transpose(1, 2).reshape(b, t, -1).to(x.dtype))

    def caption_kv(self, y: torch.Tensor) -> tuple:
        """The serving route's caption keys and values (B, Lc, H, hd) in y's
        dtype, the keys through the qk-norm in f32 rounded once."""
        yk = self.wk_y(y)
        if self.qk_norm:
            yk = norm_f32(yk, self.ky_norm).to(yk.dtype)
        return self._heads(yk, self.kvh), self._heads(self.wv_y(y), self.kvh)

    def _served(self, x: torch.Tensor, cis: torch.Tensor,
                y_kv: Optional[tuple]) -> torch.Tensor:
        """The serving route: (B, T, H, D) buffers in the stream's dtype, read
        by the kernel as (B, H, T, D) views; y_kv from `caption_kv`."""
        b, t, _ = x.shape
        norm = lambda name: getattr(self, name) if self.qk_norm else None
        q = rotate_rounded(self.wq(x), norm("q_norm"), self.h, cis)
        k = self._heads(rotate_rounded(self.wk(x), norm("k_norm"), self.kvh, cis), self.kvh)
        v = self._heads(self.wv(x), self.kvh)
        bhtd = lambda a: a.transpose(1, 2)
        scale = self.hd ** -0.5
        out = bhtd(flash_attention(bhtd(q), bhtd(k), bhtd(v), scale))
        if self.y_dim > 0 and y_kv is not None:
            yk, yv = y_kv
            yout = bhtd(flash_attention(bhtd(q), bhtd(yk), bhtd(yv), scale))
            gate = torch.tanh(self.gate.to(torch.float32)).to(out.dtype)
            out = torch.addcmul(out, yout, gate[:, None])
        return self.wo(out.reshape(b, t, -1))


class SwiGLUFeedForward(nn.Module):
    def __init__(self, dim: int, multiple_of: int = 256,
                 ffn_dim_multiplier: Optional[float] = None):
        super().__init__()
        hidden = int(2 * (4 * dim) / 3)
        if ffn_dim_multiplier is not None:
            hidden = int(ffn_dim_multiplier * hidden)
        hidden = multiple_of * (-(-hidden // multiple_of))
        self.w1 = nn.Linear(dim, hidden, bias=False)
        self.w2 = nn.Linear(hidden, dim, bias=False)
        self.w3 = nn.Linear(dim, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class FlagDiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, n_kv_heads: Optional[int], multiple_of: int,
                 ffn_dim_multiplier: Optional[float], norm_eps: float, qk_norm: bool,
                 y_dim: int, use_flash: bool = False):
        super().__init__()
        self.adaLN_modulation = nn.Linear(dim, 6 * dim)
        self.attention_y_norm = RMSNorm(y_dim, norm_eps)
        self.attention_norm = RMSNorm(dim, norm_eps)
        self.attention = FlagAttention(dim, num_heads, n_kv_heads, y_dim, qk_norm, use_flash)
        self.ffn_norm = RMSNorm(dim, norm_eps)
        self.feed_forward = SwiGLUFeedForward(dim, multiple_of, ffn_dim_multiplier)

    def caption(self, context: torch.Tensor):
        """What the block's attention reads of the caption: its normed
        tokens (parity route), or their keys and values (serving route)."""
        y = self.attention_y_norm(context)
        return self.attention.caption_kv(y) if self.attention.use_flash else y

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, y,
                adaln: torch.Tensor, cis: Optional[torch.Tensor] = None) -> torch.Tensor:
        """y: `caption(context)`."""
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = self.adaLN_modulation(
            F.silu(adaln)).chunk(6, dim=-1)
        h = x + g_msa[:, None, :] * self.attention(
            modulate(self.attention_norm(x), s_msa, sc_msa), cos, sin, y, cis)
        return h + g_mlp[:, None, :] * self.feed_forward(
            modulate(self.ffn_norm(h), s_mlp, sc_mlp))


class TxtFlagLargeDiT(nn.Module):
    """x (B, T, in_ch), t (B,), context (B, Lc, context_dim) -> eps (B, T, in_ch).

    use_flash=True takes the serving route (module docstring); the flash
    kernel has no backward, so the trainers build it with use_flash=False."""

    def __init__(self, in_channels: int = 20, context_dim: int = 1024, hidden_size: int = 576,
                 depth: int = 4, num_heads: int = 8, max_len: int = 1000,
                 n_kv_heads: Optional[int] = None, multiple_of: int = 256,
                 ffn_dim_multiplier: Optional[float] = None, norm_eps: float = 1e-5,
                 qk_norm: bool = False, use_flash: bool = False):
        super().__init__()
        self.in_channels, self.context_dim, self.use_flash = in_channels, context_dim, use_flash
        self.proj_in = nn.Linear(in_channels, hidden_size)
        self.t_mlp_0 = nn.Linear(256, hidden_size)
        self.t_mlp_2 = nn.Linear(hidden_size, hidden_size)
        self.cap_norm = nn.LayerNorm(context_dim, eps=1e-5)
        self.cap_proj = nn.Linear(context_dim, hidden_size)
        self.blocks = nn.ModuleList([
            FlagDiTBlock(hidden_size, num_heads, n_kv_heads, multiple_of, ffn_dim_multiplier,
                         norm_eps, qk_norm, context_dim, use_flash) for _ in range(depth)])
        self.final_adaLN = nn.Linear(hidden_size, 2 * hidden_size)
        self.final_norm = nn.LayerNorm(hidden_size, eps=1e-6, elementwise_affine=False)
        self.final_linear = nn.Linear(hidden_size, in_channels)
        # float32 whatever the module's dtype: kept off the module's
        # buffers, which .to(dtype) would round
        self._rotary_cpu = precompute_rotary(hidden_size // num_heads, max_len)
        self._rotary: dict = {}
        self._memo: Optional[dict] = None  # caption_memo's, while it is open
        for m in (self.final_adaLN, self.final_linear) + tuple(
                b.adaLN_modulation for b in self.blocks):
            nn.init.zeros_(m.weight)
            nn.init.zeros_(m.bias)

    def rotary(self, device: torch.device) -> tuple:
        """The cos and sin tables on `device`, and the serving route's
        complex64 cos + i sin, copied once per device (outside inference
        mode, so that a forward under autograd may save them)."""
        if device not in self._rotary:
            with torch.inference_mode(False):
                cos, sin = (a.to(device) for a in self._rotary_cpu)
                self._rotary[device] = (cos, sin, torch.complex(cos, sin))
        return self._rotary[device]

    @contextlib.contextmanager
    def caption_memo(self):
        """While open, the forward computes what it reads of the caption alone
        (the pooled caption's projection, each block's `caption`) once per
        context tensor and reuses it while the same tensor comes back, as
        over a sampler's steps: on the serving route ~16 launches a block
        and step fewer, the same result bit for bit. Inside, the caller
        changes neither the weights nor the context tensor."""
        self._memo = {}
        try:
            yield
        finally:
            self._memo = None

    def _caption(self, context: torch.Tensor) -> tuple:
        memo = self._memo
        if memo is not None and memo.get("context") is context:
            return memo["caption"]
        caption = (self.cap_proj(self.cap_norm(context.mean(dim=1))),
                   [block.caption(context) for block in self.blocks])
        if memo is not None:  # the tensor itself, compared by identity
            memo.update(context=context, caption=caption)
        return caption

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                w_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """w_cond is accepted and unused, as in the reference."""
        h = self.proj_in(x)
        t_emb = linear_promoted(F.silu(linear_promoted(timestep_embedding(t, 256), self.t_mlp_0)),
                                self.t_mlp_2)
        cap, ys = self._caption(context)
        # the f32 timestep path stays out of the modulations: an f32 adaln
        # would promote every gated residual of a bf16 stream
        adaln = (t_emb + cap).to(h.dtype)
        cos, sin, cis = self.rotary(h.device)
        for block, y in zip(self.blocks, ys):
            h = block(h, cos, sin, y, adaln, cis)
        shift, scale = self.final_adaLN(F.silu(adaln)).chunk(2, dim=-1)
        return self.final_linear(modulate(self.final_norm(h), shift, scale))
