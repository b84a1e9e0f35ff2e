"""A DeepSeek-V3-family decoder LLM as a caption tower: its final-norm
hidden states condition the denoiser (no LM head is built).

The block is HF `modeling_deepseek_v3`'s (Moonlight-16B-A3B at its published
widths: hidden 2048, 27 layers, the first dense):

    h = x + MLA(RMSNorm(x));  out = h + MLP(RMSNorm(h))

- MLA without a query LoRA: q = Wq x (H heads of nope 128 + rope 64);
  [c_kv | k_rope] = W_kva x (512 + 64); [k_nope | v] = W_kvb RMSNorm(c_kv)
  per head (128 + 128); rotary (theta 50000) on the 64 rope dims of q and of
  the one shared k_rope, in DeepSeek's interleaved pairing (HF's
  `apply_rotary_pos_emb_interleave`: de-interleave, then rotate halves);
  causal softmax(q k^T * 192^-1/2) v; Wo.
- MLP: a SwiGLU of width 11264 in the first `first_k_dense_replace` layers;
  after them the mixture of experts: a sigmoid router with a correction
  bias, the top `num_experts_per_tok` of `n_routed_experts` chosen
  group-limited (`noaux_tc`), their weights normalised and scaled by
  `routed_scaling_factor`, each expert a SwiGLU of `moe_intermediate_size`,
  plus the shared experts as one SwiGLU `n_shared_experts` times as wide.

Numerics as HF's bf16 model has them: the norms in f32, the router logits
in f32; the rotary and the routed sum in f32 here too (HF rounds its
rotary tables to bf16). Key names are HF's (`model.layers.N.mlp.experts.E.
gate_proj.weight`, ...), so a checkpoint loads with `load_state_dict`.

The routed experts run through `nn/moe_experts.py`: on the card in bf16
without autograd the grouped kernel K7 over a dispatch sorted on the device
(no host sync, so a CUDA graph captures the tower); elsewhere the plain
per-expert loop. The module is meant to be built on the meta device and
loaded with `load_state_dict(..., assign=True)` (`pipeline.load_params`),
so that its 15.6 B parameters are never materialised in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.nn import moe_experts
from audiolcm_torch.nn.packing import weights_version


@dataclasses.dataclass(frozen=True)
class MoELLMConfig:
    """The HF config keys the tower reads (Moonlight-16B-A3B's values)."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    attention_bias: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "MoELLMConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace and layer % self.moe_layer_freq == 0


class RMSNorm(nn.Module):
    """HF DeepseekV3RMSNorm: normalise in f32, round to the input's dtype,
    then scale."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * h.to(x.dtype)


def rotary_tables(length: int, dim: int, theta: float, device) -> tuple:
    """(cos, sin), each (length, dim) f32: HF's default rope, the angles
    t * theta^(-2i/dim) computed in f32, each repeated for the two halves."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device, dtype=torch.int64).float() / dim)
    freqs = torch.arange(length, device=device, dtype=torch.float32)[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rotary_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (B, H, T, d): the interleaved pairs (x[2i], x[2i+1]) laid out as
    [evens | odds] and rotated by rotate_half, in f32; -> x's dtype."""
    b, h, t, d = x.shape
    x32 = x.float().view(b, h, t, d // 2, 2).transpose(3, 4).reshape(b, h, t, d)
    half = torch.cat([-x32[..., d // 2:], x32[..., :d // 2]], dim=-1)
    return (x32 * cos + half * sin).to(x.dtype)


class MLAttention(nn.Module):
    """Multi-head latent attention without a query LoRA, causal."""

    def __init__(self, c: MoELLMConfig):
        super().__init__()
        if c.q_lora_rank is not None:
            raise ValueError("only q_lora_rank None (Moonlight's) is built")
        self.c = c
        h, d = c.num_attention_heads, c.hidden_size
        self.qk_dim = c.qk_nope_head_dim + c.qk_rope_head_dim
        self.q_proj = nn.Linear(d, h * self.qk_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, c.kv_lora_rank + c.qk_rope_head_dim,
                                            bias=c.attention_bias)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps)
        self.kv_b_proj = nn.Linear(c.kv_lora_rank, h * (c.qk_nope_head_dim + c.v_head_dim),
                                   bias=False)
        self.o_proj = nn.Linear(h * c.v_head_dim, d, bias=c.attention_bias)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        c, (b, t, _) = self.c, x.shape
        h, nope, rope = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
        q = self.q_proj(x).view(b, t, h, self.qk_dim).transpose(1, 2)
        q_nope, q_rot = q.split([nope, rope], dim=-1)
        ckv, k_rot = self.kv_a_proj_with_mqa(x).split([c.kv_lora_rank, rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(ckv)).view(b, t, h, nope + c.v_head_dim)
        k_nope, v = kv.transpose(1, 2).split([nope, c.v_head_dim], dim=-1)
        q_rot = apply_rotary_interleaved(q_rot, cos, sin)
        k_rot = apply_rotary_interleaved(k_rot.view(b, 1, t, rope), cos, sin)
        q = torch.cat([q_nope, q_rot], dim=-1)
        k = torch.cat([k_nope, k_rot.expand(b, h, t, rope)], dim=-1)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             scale=self.qk_dim ** -0.5)
        return self.o_proj(out.transpose(1, 2).reshape(b, t, h * c.v_head_dim))


class SwiGLU(nn.Module):
    """HF DeepseekV3MLP: down(silu(gate x) * up x)."""

    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(d, width, bias=False)
        self.up_proj = nn.Linear(d, width, bias=False)
        self.down_proj = nn.Linear(width, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))

    def add_to(self, residual: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return residual + self(x)


class TopkRouter(nn.Module):
    """The sigmoid router with `e_score_correction_bias` (HF
    DeepseekV3TopkRouter, `noaux_tc`): (T, d) -> the chosen experts (T, k)
    int64 and their weights (T, k) f32, from f32 logits."""

    def __init__(self, c: MoELLMConfig):
        super().__init__()
        self.c = c
        self.weight = nn.Parameter(torch.empty(c.n_routed_experts, c.hidden_size))
        self.register_buffer("e_score_correction_bias", torch.zeros(c.n_routed_experts))

    def forward(self, x: torch.Tensor):
        c = self.c
        scores = F.linear(x.float(), self.weight.float()).sigmoid()
        choice = scores + self.e_score_correction_bias.float()
        per_group = c.n_routed_experts // c.n_group
        groups = choice.view(-1, c.n_group, per_group).topk(2, dim=-1)[0].sum(-1)
        keep = torch.zeros_like(groups).scatter_(1, groups.topk(c.topk_group, dim=-1)[1], 1.0)
        keep = keep[:, :, None].expand(-1, -1, per_group).reshape(-1, c.n_routed_experts)
        idx = choice.masked_fill(keep == 0, 0.0).topk(c.num_experts_per_tok, dim=-1)[1]
        w = scores.gather(1, idx)
        if c.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * c.routed_scaling_factor


class MoE(nn.Module):
    """The routed experts and the shared ones; `add_to(residual, x)` ->
    residual + shared(x) + the routed sum, through K7 where it takes x."""

    def __init__(self, c: MoELLMConfig):
        super().__init__()
        self.gate = TopkRouter(c)
        self.experts = nn.ModuleList(SwiGLU(c.hidden_size, c.moe_intermediate_size)
                                     for _ in range(c.n_routed_experts))
        self.shared_experts = SwiGLU(c.hidden_size, c.moe_intermediate_size * c.n_shared_experts)
        self._stacked, self._stacked_key = None, None

    def _weights(self):
        return [e.weight for m in ("gate_proj", "up_proj", "down_proj")
                for e in (getattr(x, m) for x in self.experts)]

    def stacked_weights(self) -> tuple:
        """(gate (E, I, d), up (E, I, d), down (E, d, I)) as K7 reads them,
        made once per weight version (`packing.weights_version`) by
        `moe_experts.stack`: a view where the experts' weights lie back to
        back in one buffer, else one copy that they then view."""
        key = weights_version(self._weights())
        if self._stacked_key != key:
            self._stacked = tuple(
                moe_experts.stack([getattr(x, m) for x in self.experts])
                for m in ("gate_proj", "up_proj", "down_proj"))
            self._stacked_key = weights_version(self._weights())
        return self._stacked

    def add_to(self, residual: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2, res2 = x.reshape(-1, shape[-1]), residual.reshape(-1, shape[-1])
        idx, w = self.gate(x2)
        shared = self.shared_experts(x2)
        if moe_experts.takes(x2):
            out = moe_experts.routed_experts(x2, idx, w, self.stacked_weights(), res2, shared)
        else:
            routed = moe_experts.routed_experts_plain(
                x2, idx, w, [(e.gate_proj.weight, e.up_proj.weight, e.down_proj.weight)
                             for e in self.experts])
            out = res2 + (routed.to(x.dtype) + shared)
        return out.view(shape)


class DecoderLayer(nn.Module):
    def __init__(self, c: MoELLMConfig, layer: int):
        super().__init__()
        self.self_attn = MLAttention(c)
        self.mlp = MoE(c) if c.is_moe(layer) else SwiGLU(c.hidden_size, c.intermediate_size)
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return self.mlp.add_to(x, self.post_attention_layernorm(x))


class _Model(nn.Module):
    def __init__(self, c: MoELLMConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(c, i) for i in range(c.num_hidden_layers))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps)


class MoELLM(nn.Module):
    """ids (B, L) int64 -> the final norm's hidden states (B, L, hidden)."""

    def __init__(self, c: MoELLMConfig = MoELLMConfig()):
        super().__init__()
        self.config = c
        self.model = _Model(c)

    def pack_expert_weights(self) -> None:
        """K7's stacked expert weights of every MoE layer, made now (at the
        pipeline's build, before any graph capture)."""
        for layer in self.model.layers:
            if isinstance(layer.mlp, MoE):
                layer.mlp.stacked_weights()

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        c, m = self.config, self.model
        x = m.embed_tokens(ids)
        cos, sin = rotary_tables(ids.shape[1], c.qk_rope_head_dim, c.rope_theta, ids.device)
        for layer in m.layers:
            x = layer(x, cos, sin)
        return m.norm(x)
