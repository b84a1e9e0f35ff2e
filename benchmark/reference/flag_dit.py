"""The plain reference of the Flag-DiT teacher: TxtFlagLargeDiT's forward
pass, its state-dict layout, and the DDIM teacher's whole generate over it,
in float32 (or the control's fp8 products, `ops.Precision`).

The block is the LLaMA-style "Flag-DiT" of Lumina-T2X (arXiv:2405.05945,
github.com/Alpha-VLLM/Lumina-T2X), as AudioLCM's
`ldm/modules/diffusionmodules/flag_large_dit.py:527` TxtFlagLargeDiT uses it
over a 1-D latent:

- tokens: a linear projection of the latent frames (no patches);
- conditioning: adaln = MLP(sinusoid(t)) + Linear(LayerNorm(mean of the
  caption's tokens)), each MLP SiLU between two linears;
- each block, with modulate(x, shift, scale) = x (1 + scale) + shift:
    h = x + gate_msa * Attn(modulate(RMSNorm(x), shift_msa, scale_msa), RMSNorm_y(y))
    out = h + gate_mlp * SwiGLU(modulate(RMSNorm(h), shift_mlp, scale_mlp)),
  the six from Linear(SiLU(adaln)); Attn: q, k, v = Wq x, Wk x, Wv x; with
  qk-norm, LayerNorms over the whole q and k vectors; rotary (theta 1e4)
  over interleaved pairs of each head's q and k at positions 0..T-1;
  softmax(q k^T / sqrt(hd)) v, plus tanh(gate_h) softmax(q k_y^T / sqrt(hd))
  v_y with k_y = LN_y(Wk_y y), v_y = Wv_y y un-rotated; then Wo;
  SwiGLU(x) = W2(silu(W1 x) * W3 x) with hidden width 8d/3 (times
  ffn_dim_multiplier), rounded up to multiple_of;
- the head: Linear(modulate(LayerNorm(h), shift, scale)), a LayerNorm
  without affine parameters (eps 1e-6), the two from Linear(SiLU(adaln)).

Departures from Lumina-T2X's published Flag-DiT, as the port has the model
(AudioLCM's source is not in this repository): the timestep MLP, the
caption's pooled projection and every adaLN linear run at the full width
d, where Lumina caps their width at min(d, 1024); no attention mask (every
mask of the generate is all ones, so the pooled caption is its plain mean);
full multi-head attention (n_kv_heads unset), as the 2B preset has it.

Weights are read by the port's key names (`layout`), each cast to float32
when its layer runs, so the reference holds one layer's float32 weights at
a time beside the served state dict. Activations are channels-last (B, T,
C). It imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import model, ops, samplers
from benchmark.reference.layout import FREQ_DIM, Layout

LN_EPS, FINAL_EPS, THETA = 1e-5, 1e-6, 10000.0


def ffn_hidden(c: dict) -> int:
    """SwiGLU's hidden width: 8d/3, times ffn_dim_multiplier, rounded up to
    multiple_of (6144 at d = 2304)."""
    hidden = int(2 * (4 * c["hidden_size"]) / 3)
    if c.get("ffn_dim_multiplier") is not None:
        hidden = int(c["ffn_dim_multiplier"] * hidden)
    m = c["multiple_of"]
    return m * (-(-hidden // m))


def layout(c: dict) -> Layout:
    """(key, shape) of every TxtFlagLargeDiT tensor, in the port's names."""
    d, ctx, cin = c["hidden_size"], c["context_dim"], c["in_channels"]
    kv = (c.get("n_kv_heads") or c["num_heads"]) * (d // c["num_heads"])
    out: Layout = [("proj_in.weight", (d, cin)), ("proj_in.bias", (d,)),
                   ("t_mlp_0.weight", (d, FREQ_DIM)), ("t_mlp_0.bias", (d,)),
                   ("t_mlp_2.weight", (d, d)), ("t_mlp_2.bias", (d,)),
                   ("cap_norm.weight", (ctx,)), ("cap_norm.bias", (ctx,)),
                   ("cap_proj.weight", (d, ctx)), ("cap_proj.bias", (d,))]
    hid = ffn_hidden(c)
    for i in range(c["depth"]):
        p, a = f"blocks.{i}", f"blocks.{i}.attention"
        out += [(f"{p}.adaLN_modulation.weight", (6 * d, d)),
                (f"{p}.adaLN_modulation.bias", (6 * d,)),
                (f"{p}.attention_y_norm.weight", (ctx,)), (f"{p}.attention_norm.weight", (d,)),
                (f"{a}.wq.weight", (d, d)), (f"{a}.wk.weight", (kv, d)),
                (f"{a}.wv.weight", (kv, d))]
        if c["qk_norm"]:
            out += [(f"{a}.q_norm.weight", (d,)), (f"{a}.q_norm.bias", (d,)),
                    (f"{a}.k_norm.weight", (kv,)), (f"{a}.k_norm.bias", (kv,))]
        out += [(f"{a}.wk_y.weight", (kv, ctx)), (f"{a}.wv_y.weight", (kv, ctx))]
        if c["qk_norm"]:
            out += [(f"{a}.ky_norm.weight", (kv,)), (f"{a}.ky_norm.bias", (kv,))]
        f = f"{p}.feed_forward"
        out += [(f"{a}.gate", (c["num_heads"],)), (f"{a}.wo.weight", (d, d)),
                (f"{p}.ffn_norm.weight", (d,)), (f"{f}.w1.weight", (hid, d)),
                (f"{f}.w2.weight", (d, hid)), (f"{f}.w3.weight", (hid, d))]
    out += [("final_adaLN.weight", (2 * d, d)), ("final_adaLN.bias", (2 * d,)),
            ("final_linear.weight", (cin, d)), ("final_linear.bias", (cin,))]
    return out


def rotary(x: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, hd) float32, each interleaved pair (x[2i], x[2i+1]) of a
    head rotated by t * theta^(-2i/hd) at position t; the angles in float64."""
    t, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / THETA ** (np.arange(0, hd, 2) / hd)
    angles = torch.from_numpy(np.outer(np.arange(t), freqs)).to(x.device)
    cos, sin = (f(angles).float()[None, :, None, :] for f in (torch.cos, torch.sin))
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None]) + shift[:, None]


def _attention(p, sd, a, c, x, y):
    """The block's attention with its gated caption branch, x (B, T, d), y
    (B, Lc, context_dim) already RMS-normed."""
    b, t, d = x.shape
    h = c["num_heads"]
    hd, kvh = d // h, c.get("n_kv_heads") or h
    w = lambda name: sd[f"{a}.{name}.weight"]
    ln = lambda z, name: ops.layer_norm(z, w(name), sd[f"{a}.{name}.bias"], LN_EPS)
    q, k, v = (ops.linear(p, x, w(n)) for n in ("wq", "wk", "wv"))
    yk, yv = ops.linear(p, y, w("wk_y")), ops.linear(p, y, w("wv_y"))
    if c["qk_norm"]:
        q, k, yk = ln(q, "q_norm"), ln(k, "k_norm"), ln(yk, "ky_norm")
    heads = lambda z, n: z.reshape(b, z.shape[1], n, hd).repeat_interleave(h // n, dim=2)
    q, k = rotary(heads(q, h)), rotary(heads(k, kvh))
    bhtd = lambda z: z.transpose(1, 2)
    out = ops.attention(p, bhtd(q), bhtd(k), bhtd(heads(v, kvh)), hd ** -0.5)
    yout = ops.attention(p, bhtd(q), bhtd(heads(yk, kvh)), bhtd(heads(yv, kvh)), hd ** -0.5)
    out = out + torch.tanh(sd[f"{a}.gate"].float())[None, :, None, None] * yout
    return ops.linear(p, out.transpose(1, 2).reshape(b, t, d), w("wo"))


def dit(sd: dict, c: dict, x, t, ctx, p: ops.Precision = ops.F32) -> torch.Tensor:
    """x (B, T, C_in), t (B,), ctx (B, Lc, context_dim) -> eps (B, T, C_in)."""
    lin = lambda z, name: ops.linear(p, z, sd[f"{name}.weight"], sd.get(f"{name}.bias"))
    y = ctx.float()
    temb = lin(F.silu(lin(model.timestep_embedding(t), "t_mlp_0")), "t_mlp_2")
    pooled = ops.layer_norm(y.mean(dim=1), sd["cap_norm.weight"], sd["cap_norm.bias"], LN_EPS)
    adaln = F.silu(temb + lin(pooled, "cap_proj"))
    h = lin(x.float(), "proj_in")
    eps = c["norm_eps"]
    for i in range(c["depth"]):
        pre = f"blocks.{i}"
        mods = lin(adaln, f"{pre}.adaLN_modulation").chunk(6, dim=-1)
        z = _modulate(_rms(h, sd[f"{pre}.attention_norm.weight"], eps), mods[0], mods[1])
        a = _attention(p, sd, f"{pre}.attention", c, z,
                       _rms(y, sd[f"{pre}.attention_y_norm.weight"], eps))
        h = h + mods[2][:, None] * a
        f = f"{pre}.feed_forward"
        z = _modulate(_rms(h, sd[f"{pre}.ffn_norm.weight"], eps), mods[3], mods[4])
        z = lin(F.silu(lin(z, f"{f}.w1")) * lin(z, f"{f}.w3"), f"{f}.w2")
        h = h + mods[5][:, None] * z
    shift, scale = lin(adaln, "final_adaLN").chunk(2, dim=-1)
    h = _modulate(F.layer_norm(h, (h.shape[-1],), eps=FINAL_EPS), shift, scale)
    return lin(h, "final_linear")


def ddim_sample(sd, c, sampler, sched, ctx, uncond, x_t, p=ops.F32):
    """DDIM (eta 0) with classifier-free guidance over this denoiser: the
    unconditional and the conditional forward apart, e_u + s (e_c - e_u)
    (`samplers.ddim_sample`'s grid and update)."""
    acp = samplers.alphas_cumprod(sched).astype(np.float64)
    n = sched["timesteps"]
    ts = np.clip(np.arange(0, n, n // sampler["num_steps"]) + 1, 0, n - 1)
    prev = np.concatenate([acp[:1], acp[ts[:-1]]])
    s, b, f32 = sampler["guidance_scale"], x_t.shape[0], np.float32
    uc = uncond.expand(ctx.shape)
    x = x_t
    for t, a, a_prev in zip(ts[::-1], acp[ts][::-1], prev[::-1]):
        a, a_prev = f32(a), f32(a_prev)
        tt = torch.full((b,), int(t), device=x.device)
        e_u = dit(sd, c, x, tt, uc, p)
        e_c = dit(sd, c, x, tt, ctx, p)
        e = e_u + s * (e_c - e_u)
        x0 = (x - float(np.sqrt(f32(1) - a)) * e) / float(np.sqrt(a))
        x = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(f32(1) - a_prev)) * e
    return x


def generate(sds: dict, config: dict, clap_ids, t5_ids, x_t, uncond_ids,
             p: ops.Precision = ops.F32):
    """Token ids, the empty prompt's ids and x_T -> (wav (B, 256 * 2T), mel
    (B, 2T, 80)), float32: the text towers, DDIM over this denoiser, the VAE
    decode and the vocoder (`model`)."""
    sampler = config["sampler"]
    if sampler["kind"] != "ddim":
        raise ValueError(f"the Flag-DiT teacher samples with ddim, not {sampler['kind']!r}")
    with ops.computed_in(p):
        ctx = model.context(sds, config, clap_ids, t5_ids, p)
        uc = model.context(sds, config, *uncond_ids, p)
        z = ddim_sample(sds["dit"], config["dit"], sampler, config["schedule"], ctx, uc, x_t, p)
        mel = model.vae_decode(sds["vae"], config["vae"], z / config["scale_factor"], p)
        return model.vocoder(sds["vocoder"], config["vocoder"], mel, p), mel
