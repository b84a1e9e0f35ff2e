"""The plain reference of the caption LLM (a DeepSeek-V3-family decoder,
Moonlight-16B-A3B at its published widths) and of the LCM generate that
conditions the DiT on its states through a third condition embedder, in
float32 (or the control's fp8 products, `ops.Precision`).

The tower follows HF transformers' `modeling_deepseek_v3` (the model type
of github.com/MoonshotAI/Moonlight's config.json), from the embedding to
the final RMSNorm (no LM head):

- each layer: h = x + Attn(RMSNorm(x)); out = h + MLP(RMSNorm(h)), RMSNorm
  x / sqrt(mean(x^2) + eps) * w;
- Attn, multi-head latent attention without a query LoRA: q = Wq x split
  per head into nope (128) and rope (64); [c | k_rope] = W_kva x (512 +
  64); [k_nope | v] = W_kvb RMSNorm(c) per head (128 + 128); q_rope and the
  shared k_rope rotated by HF's `apply_rotary_pos_emb_interleave` (each
  head's interleaved pairs laid out as [evens | odds], then x cos +
  rotate_half(x) sin with the angles t theta^(-2i/64) in float32);
  softmax(q k^T / sqrt(192)) v over the keys at or before each query; Wo;
- MLP: the SwiGLU down(silu(gate x) up x) of width 11264 in the first
  `first_k_dense_replace` layers; then the mixture: scores =
  sigmoid(W_router x) in float32; choice = scores + e_score_correction_bias,
  limited to the top `topk_group` of `n_group` groups (each scored by its
  two best); the top `num_experts_per_tok` by choice; weights = their
  scores, normalised to sum 1, times `routed_scaling_factor`; out = sum of
  weight x expert SwiGLU (width 1408), looping over the experts, + the
  shared experts' SwiGLU (width 1408 x n_shared_experts).

Departures from HF's bf16 model, which computes its rotary tables and the
products in bf16: every operation here is float32 (the reference's point);
the routed sum is added to the shared experts' output before the residual,
not rounded to bf16 first. Weights are read by HF's key names (`layout`),
each cast to float32 when its layer runs, so the reference holds one
layer's float32 weights at a time beside the served state dict. The
configuration's top-level keys are the model's config.json keys.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import layout as base_layout
from benchmark.reference import model, ops, samplers
from benchmark.reference.layout import Layout


def is_moe(c: dict, i: int) -> bool:
    return i >= c["first_k_dense_replace"] and i % c["moe_layer_freq"] == 0


def layout(c: dict) -> Layout:
    """(key, shape) of every tensor of the tower, HF's names. In each expert
    layer the experts' gate projections come back to back, then their up
    and their down projections: drawn into one buffer in this order, each
    is one (E, N, K) block."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    out: Layout = [("model.embed_tokens.weight", (c["vocab_size"], d))]
    for i in range(c["num_hidden_layers"]):
        p, a = f"model.layers.{i}", f"model.layers.{i}.self_attn"
        out += [(f"{p}.input_layernorm.weight", (d,)),
                (f"{a}.q_proj.weight", (h * qk, d)),
                (f"{a}.kv_a_proj_with_mqa.weight", (c["kv_lora_rank"] + c["qk_rope_head_dim"], d)),
                (f"{a}.kv_a_layernorm.weight", (c["kv_lora_rank"],)),
                (f"{a}.kv_b_proj.weight",
                 (h * (c["qk_nope_head_dim"] + c["v_head_dim"]), c["kv_lora_rank"])),
                (f"{a}.o_proj.weight", (d, h * c["v_head_dim"])),
                (f"{p}.post_attention_layernorm.weight", (d,))]
        if not is_moe(c, i):
            out += _swiglu(f"{p}.mlp", d, c["intermediate_size"])
            continue
        m, inter, n = f"{p}.mlp", c["moe_intermediate_size"], c["n_routed_experts"]
        out += [(f"{m}.gate.weight", (n, d)), (f"{m}.gate.e_score_correction_bias", (n,))]
        for proj, shape in (("gate_proj", (inter, d)), ("up_proj", (inter, d)),
                            ("down_proj", (d, inter))):
            out += [(f"{m}.experts.{e}.{proj}.weight", shape) for e in range(n)]
        out += _swiglu(f"{m}.shared_experts", d, inter * c["n_shared_experts"])
    out.append(("model.norm.weight", (d,)))
    return out


def _swiglu(name: str, d: int, width: int) -> Layout:
    return [(f"{name}.gate_proj.weight", (width, d)), (f"{name}.up_proj.weight", (width, d)),
            (f"{name}.down_proj.weight", (d, width))]


def dit_layout(c: dict) -> Layout:
    """ConcatDiT2MLP's layout (`layout.dit`) and the third condition
    embedder over the LLM's states (`c3_embedder`, llm_context_dim ->
    hidden_size)."""
    out = base_layout.dit(c)
    e, h = "c3_embedder", c["hidden_size"]
    out += [(f"{e}.mlp.0.weight", (h, c["llm_context_dim"])), (f"{e}.mlp.0.bias", (h,)),
            (f"{e}.mlp.2.weight", (h, h)), (f"{e}.mlp.2.bias", (h,)),
            (f"{e}.mlp.3.weight", (h,)), (f"{e}.mlp.3.bias", (h,))]
    return out


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rotate(x, cos, sin):
    """x (B, H, T, 64): interleaved pairs to [evens | odds], then rotated."""
    b, h, t, d = x.shape
    x = x.reshape(b, h, t, d // 2, 2).transpose(3, 4).reshape(b, h, t, d)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1) * sin


def _attention(p, sd, a, c, x):
    b, t, d = x.shape
    h, nope, rope, dv = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                         c["v_head_dim"])
    w = lambda name: sd[f"{a}.{name}.weight"]
    q = ops.linear(p, x, w("q_proj")).reshape(b, t, h, nope + rope).transpose(1, 2)
    kva = ops.linear(p, x, w("kv_a_proj_with_mqa"))
    ckv, k_rope = kva[..., :c["kv_lora_rank"]], kva[..., c["kv_lora_rank"]:]
    kv = ops.linear(p, _rms(ckv, w("kv_a_layernorm"), c["rms_norm_eps"]), w("kv_b_proj"))
    kv = kv.reshape(b, t, h, nope + dv).transpose(1, 2)
    inv = 1.0 / c["rope_theta"] ** (torch.arange(0, rope, 2, device=x.device).float() / rope)
    angles = torch.arange(t, device=x.device).float()[:, None] * inv[None]
    cos, sin = torch.cat([angles, angles], -1).cos(), torch.cat([angles, angles], -1).sin()
    q = torch.cat([q[..., :nope], _rotate(q[..., nope:], cos, sin)], dim=-1)
    k_rope = _rotate(k_rope.reshape(b, 1, t, rope), cos, sin).expand(b, h, t, rope)
    k = torch.cat([kv[..., :nope], k_rope], dim=-1)
    out = _causal_attention(p, q, k, kv[..., nope:], (nope + rope) ** -0.5)
    return ops.linear(p, out.transpose(1, 2).reshape(b, t, h * dv), w("o_proj"))


def _causal_attention(p, q, k, v, scale):
    """softmax(q k^T scale) v over the keys at or before each query, the
    mask a 0/1 factor on the exponentials: no -inf, which the control's
    per-tensor fp8 scales would turn into NaN."""
    logits = ops.matmul(p, q, k.transpose(-1, -2)) * scale
    keep = torch.ones(q.shape[2], k.shape[2], device=q.device).tril()
    e = torch.exp(logits - logits.amax(-1, keepdim=True)) * keep
    return ops.matmul(p, e / e.sum(-1, keepdim=True), v)


def _swiglu_forward(p, sd, name, x):
    w = lambda proj: sd[f"{name}.{proj}.weight"]
    return ops.linear(p, F.silu(ops.linear(p, x, w("gate_proj"))) * ops.linear(p, x, w("up_proj")),
                      w("down_proj"))


def route(sd: dict, m: str, c: dict, x: torch.Tensor):
    """x (N, d) -> (experts (N, k), weights (N, k)): HF DeepseekV3TopkRouter."""
    n, groups = c["n_routed_experts"], c["n_group"]
    scores = torch.sigmoid(x.float() @ sd[f"{m}.gate.weight"].float().T)
    choice = scores + sd[f"{m}.gate.e_score_correction_bias"].float()
    group_scores = choice.reshape(-1, groups, n // groups).topk(2, dim=-1)[0].sum(-1)
    mask = torch.zeros_like(group_scores).scatter_(
        1, group_scores.topk(c["topk_group"], dim=-1)[1], 1.0)
    mask = mask[:, :, None].expand(-1, groups, n // groups).reshape(-1, n)
    idx = choice.masked_fill(mask == 0, 0.0).topk(c["num_experts_per_tok"], dim=-1)[1]
    w = scores.gather(1, idx)
    if c["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * c["routed_scaling_factor"]


def _moe(p, sd, m, c, x, routes):
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    idx, w = route(sd, m, c, x2)
    if routes is not None:
        routes.append(idx)
    out = torch.zeros_like(x2)
    for e in range(c["n_routed_experts"]):
        tok, slot = torch.where(idx == e)
        if tok.numel():
            y = _swiglu_forward(p, sd, f"{m}.experts.{e}", x2[tok])
            out = out.index_add(0, tok, y * w[tok, slot, None])
    out = out + _swiglu_forward(p, sd, f"{m}.shared_experts", x2)
    return out.reshape(b, t, d)


def forward(sd: dict, c: dict, ids: torch.Tensor, p: ops.Precision = ops.F32,
            routes: list = None, layers: list = None) -> torch.Tensor:
    """ids (B, L) -> the final norm's states (B, L, d), float32; `routes`,
    when a list, gets each expert layer's chosen experts (B L, k), and
    `layers` each layer's output (B, L, d)."""
    eps = c["rms_norm_eps"]
    x = sd["model.embed_tokens.weight"][ids].float()
    for i in range(c["num_hidden_layers"]):
        pre = f"model.layers.{i}"
        x = x + _attention(p, sd, f"{pre}.self_attn", c,
                           _rms(x, sd[f"{pre}.input_layernorm.weight"], eps))
        z = _rms(x, sd[f"{pre}.post_attention_layernorm.weight"], eps)
        x = x + (_moe(p, sd, f"{pre}.mlp", c, z, routes) if is_moe(c, i)
                 else _swiglu_forward(p, sd, f"{pre}.mlp", z))
        if layers is not None:
            layers.append(x)
    return _rms(x, sd["model.norm.weight"], eps)


def dit(sd: dict, c: dict, x, t, ctx, llm, w_emb=None, p: ops.Precision = ops.F32):
    """`model.dit` with the third condition embedder: the condition tokens
    are [CLAP half | T5 half | the LLM's states], each through its
    embedder."""
    temb = model.timestep_embedding(t)
    if w_emb is not None:
        temb = temb + ops.linear(p, w_emb, sd["t_embedder.proj_w.weight"])
    lin = lambda z, name: ops.linear(p, z, sd[f"{name}.weight"], sd[f"{name}.bias"])
    t_tok = lin(F.silu(lin(temb, "t_embedder.mlp.0")), "t_embedder.mlp.2")
    c1, c2 = ctx.float().chunk(2, dim=1)
    cond = torch.cat([model._cond_embed(p, z, sd, name) for z, name in
                      ((c1, "c1_embedder"), (c2, "c2_embedder"), (llm.float(), "c3_embedder"))],
                     dim=1)
    h = ops.conv1d(p, x.float().transpose(1, 2), sd["proj_in.weight"], sd["proj_in.bias"],
                   padding=2).transpose(1, 2)
    h = torch.cat([t_tok[:, None], cond, h], dim=1)
    h = h + sd["pos_emb.weight"].float()[None, :h.shape[1]]
    for i in range(c["depth"]):
        pre, tb = f"blocks.{i}", f"blocks.{i}.transformer_blocks.0"
        ln = lambda y, n: ops.layer_norm(y, sd[f"{tb}.{n}.weight"], sd[f"{tb}.{n}.bias"], 1e-5)
        g = model._conv1x1_cl(p, model._gn_cl(h, 32, sd, f"{pre}.norm", 1e-6), sd,
                              f"{pre}.proj_in")
        g = g + model._self_attention(p, ln(g, "norm1"), sd, f"{tb}.attn1", c["num_heads"])
        g = g + model._self_attention(p, ln(g, "norm2"), sd, f"{tb}.attn2", c["num_heads"])
        g = g + model._geglu_ff(p, ln(g, "norm3"), sd, f"{tb}.ff")
        h = model._conv1x1_cl(p, g, sd, f"{pre}.proj_out") + h
    h = model._gn_cl(h[:, cond.shape[1] + 1:], 16, sd, "final_layer.norm_final", 1e-5)
    return model._conv1x1_cl(p, h, sd, "final_layer.conv1d")


def lcm_sample(sd, dit_cfg, sampler, sched, ctx, llm, x_t, noise, p=ops.F32):
    """`samplers.lcm_sample` over this DiT."""
    acp = samplers.alphas_cumprod(sched)
    ts = samplers.lcm_timesteps(sampler["num_inference_steps"],
                                sampler["original_inference_steps"], sched["timesteps"])
    f32 = np.float32
    b, dev = x_t.shape[0], x_t.device
    w_emb = model.guidance_embedding(torch.full((b,), sampler["guidance_scale"] - 1.0, device=dev))
    x = x_t
    for i, t in enumerate(ts):
        a = f32(acp[t])
        a_prev = f32(acp[ts[i + 1]]) if i + 1 < len(ts) else a
        s = f32(t) * f32(10.0)
        c_skip = f32(0.25) / (s * s + f32(0.25))
        c_out = s / np.sqrt(s * s + f32(0.25))
        eps = dit(sd, dit_cfg, x, torch.full((b,), int(t), device=dev), ctx, llm, w_emb, p)
        x0 = (x - float(np.sqrt(f32(1) - a)) * eps) / float(np.sqrt(a))
        denoised = float(c_out) * x0 + float(c_skip) * x
        if i + 1 < len(ts):
            x = float(np.sqrt(a_prev)) * denoised + float(np.sqrt(f32(1) - a_prev)) * noise[i]
    return denoised


def generate(sds: dict, config: dict, clap_ids, t5_ids, llm_ids, x_t, noise,
             p: ops.Precision = ops.F32):
    """Token ids of the three towers and the draws -> (wav (B, 256 * 2T), mel
    (B, 2T, 80)), float32: CLAP and T5 (`model.context`), this tower, the
    LCM steps over the three-embedder DiT, the VAE decode and the vocoder."""
    if config["sampler"]["kind"] != "lcm":
        raise ValueError(f"the caption-LLM generate samples with lcm, not "
                         f"{config['sampler']['kind']!r}")
    with ops.computed_in(p):
        ctx = model.context(sds, config, clap_ids, t5_ids, p)
        llm = forward(sds["llm"], config, llm_ids, p)
        z = lcm_sample(sds["dit"], config["dit"], config["sampler"], config["schedule"], ctx,
                       llm, x_t, noise, p)
        mel = model.vae_decode(sds["vae"], config["vae"], z / config["scale_factor"], p)
        return model.vocoder(sds["vocoder"], config["vocoder"], mel, p), mel
