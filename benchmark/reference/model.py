"""The five models' forward passes, written plainly from the published
architectures over reference-layout state dicts (`layout.py`), in float32
(or the control's fp8 products, `ops.Precision`).

- `clap_text`: HF BERT-base (post-LN, erf GELU, logits scaled by d^-1/2)
  over all 77 tokens with no attention mask, then CLAP's projection
  LN(l1(x) + l2(gelu(l1(x)))).
- `t5`: HF T5-v1.1 encoder (RMSNorm, unscaled logits plus the bucketed
  relative-position bias of block 0 shared by every block, gated tanh-GELU
  feed-forward), no attention mask.
- `dit`: concatDiT.py's ConcatDiT2MLP: [timestep token | embedded CLAP half |
  embedded T5 half | proj_in(x)] + positions, blocks of GroupNorm -> 1x1 ->
  (self-attention, self-attention, kernel-9 conv-GEGLU FF) -> 1x1 -> + x,
  then GroupNorm(16) and a 1x1 head over the latent frames.
- `vae_decode`: autoencoder1d.py's decoder (res-blocks kernel 3, mid-block
  single-head attention over time scaled by C^-1/2, nearest 2x upsampling).
- `vocoder`: BigVGAN with the exact cos in its snake-beta, the alias-free
  activation as replicate-padded kaiser-sinc up/down sampling by 2, the mean
  of three AMP resblocks per stage, tanh at the end.

Activations are channels-last (B, T, C) between models, as the pipeline's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import ops
from benchmark.reference.layout import FF_KERNEL, FREQ_DIM


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n, d // n).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


# ----------------------------------------------------------------- text towers

def clap_text(sd: dict, c: dict, ids: torch.Tensor, p: ops.Precision = ops.F32) -> torch.Tensor:
    """ids (B, L) -> (B, L, d_proj)."""
    e, eps, n = "base.embeddings", c["layer_norm_eps"], c["num_heads"]
    h = (_f(sd[f"{e}.word_embeddings.weight"])[ids]
         + _f(sd[f"{e}.position_embeddings.weight"])[None, :ids.shape[1]]
         + _f(sd[f"{e}.token_type_embeddings.weight"])[0])
    h = ops.layer_norm(h, sd[f"{e}.LayerNorm.weight"], sd[f"{e}.LayerNorm.bias"], eps)
    hd = c["hidden_size"] // n
    for i in range(c["num_layers"]):
        pre = f"base.encoder.layer.{i}"
        lin = lambda x, name: ops.linear(p, x, sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"])
        q, k, v = (_heads(lin(h, f"attention.self.{m}"), n) for m in ("query", "key", "value"))
        a = _merge(ops.attention(p, q, k, v, hd ** -0.5))
        h = ops.layer_norm(h + lin(a, "attention.output.dense"),
                           sd[f"{pre}.attention.output.LayerNorm.weight"],
                           sd[f"{pre}.attention.output.LayerNorm.bias"], eps)
        f = lin(F.gelu(lin(h, "intermediate.dense")), "output.dense")
        h = ops.layer_norm(h + f, sd[f"{pre}.output.LayerNorm.weight"],
                           sd[f"{pre}.output.LayerNorm.bias"], eps)
    e1 = ops.linear(p, h, sd["projection.linear1.weight"])
    e2 = ops.linear(p, F.gelu(e1), sd["projection.linear2.weight"])
    return ops.layer_norm(e1 + e2, sd["projection.layer_norm.weight"],
                          sd["projection.layer_norm.bias"], 1e-5)


def t5_buckets(qlen: int, klen: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """HF T5's bidirectional relative-position buckets, (qlen, klen)."""
    rel = np.arange(klen)[None, :] - np.arange(qlen)[:, None]
    half = num_buckets // 2
    out = (rel > 0).astype(np.int64) * half
    arel = np.abs(rel)
    exact = half // 2
    large = exact + (np.log(np.maximum(arel, 1) / exact) / np.log(max_distance / exact)
                     * (half - exact)).astype(np.int64)
    return out + np.where(arel < exact, arel, np.minimum(large, half - 1))


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * _f(w)


def t5(sd: dict, c: dict, ids: torch.Tensor, p: ops.Precision = ops.F32) -> torch.Tensor:
    """ids (B, L) -> (B, L, d_model)."""
    t, n, eps = ids.shape[1], c["num_heads"], c["layer_norm_epsilon"]
    h = _f(sd["shared.weight"])[ids]
    buckets = torch.from_numpy(t5_buckets(t, t, c["relative_attention_num_buckets"],
                                          c["relative_attention_max_distance"])).to(ids.device)
    rel = _f(sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"])
    pos_bias = rel[buckets].permute(2, 0, 1)[None]
    for i in range(c["num_layers"]):
        pre = f"encoder.block.{i}.layer"
        w = lambda name: sd[f"{pre}.{name}.weight"]
        x = _rms(h, w("0.layer_norm"), eps)
        q, k, v = (_heads(ops.linear(p, x, w(f"0.SelfAttention.{m}")), n) for m in "qkv")
        h = h + ops.linear(p, _merge(ops.attention(p, q, k, v, 1.0, pos_bias)),
                           w("0.SelfAttention.o"))
        x = _rms(h, w("1.layer_norm"), eps)
        g = F.gelu(ops.linear(p, x, w("1.DenseReluDense.wi_0")), approximate="tanh")
        h = h + ops.linear(p, g * ops.linear(p, x, w("1.DenseReluDense.wi_1")),
                           w("1.DenseReluDense.wo"))
    return _rms(h, sd["encoder.final_layer_norm.weight"], eps)


def context(sds: dict, config: dict, clap_ids, t5_ids, p: ops.Precision = ops.F32):
    """(B, 2L, 1024): the CLAP half, then the T5 half."""
    return torch.cat([clap_text(sds["clap_text"], config["clap_text"], clap_ids, p),
                      t5(sds["t5"], config["t5"], t5_ids, p)], dim=1)


# ----------------------------------------------------------------- denoiser

def timestep_embedding(t: torch.Tensor, dim: int = FREQ_DIM) -> torch.Tensor:
    """GLIDE's sinusoid: [cos | sin], freqs exp(-ln(1e4) i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def guidance_embedding(w: torch.Tensor, dim: int = FREQ_DIM) -> torch.Tensor:
    """The LCM's w-embedding (VDM style): w*1000, divisor half-1, [sin | cos]."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=w.device) * -(math.log(10000.0) / (half - 1)))
    args = (w.float() * 1000.0)[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _conv1x1_cl(p, x, sd, name):
    return ops.linear(p, x, sd[f"{name}.weight"][:, :, 0], sd[f"{name}.bias"])


def _gn_cl(x, groups, sd, name, eps):
    return ops.group_norm(x.transpose(1, 2), groups, sd[f"{name}.weight"],
                          sd[f"{name}.bias"], eps).transpose(1, 2)


def _self_attention(p, x, sd, name, heads):
    q, k, v = (_heads(ops.linear(p, x, sd[f"{name}.to_{m}.weight"]), heads) for m in "qkv")
    a = ops.attention(p, q, k, v, (x.shape[-1] // heads) ** -0.5)
    return ops.linear(p, _merge(a), sd[f"{name}.to_out.0.weight"], sd[f"{name}.to_out.0.bias"])


def _geglu_ff(p, x, sd, name):
    h = ops.conv1d(p, x.transpose(1, 2), sd[f"{name}.net.0.proj.weight"],
                   sd[f"{name}.net.0.proj.bias"], padding=FF_KERNEL // 2)
    val, gate = h.chunk(2, dim=1)
    h = ops.conv1d(p, val * F.gelu(gate), sd[f"{name}.net.2.weight"], sd[f"{name}.net.2.bias"],
                   padding=FF_KERNEL // 2)
    return h.transpose(1, 2)


def _cond_embed(p, c, sd, name):
    h = F.gelu(ops.linear(p, c, sd[f"{name}.mlp.0.weight"], sd[f"{name}.mlp.0.bias"]),
               approximate="tanh")
    h = ops.linear(p, h, sd[f"{name}.mlp.2.weight"], sd[f"{name}.mlp.2.bias"])
    return ops.layer_norm(h, sd[f"{name}.mlp.3.weight"], sd[f"{name}.mlp.3.bias"], 1e-5)


def dit(sd: dict, c: dict, x, t, ctx, w_emb=None, p: ops.Precision = ops.F32) -> torch.Tensor:
    """x (B, T, C_in), t (B,), ctx (B, 2Lc, context_dim), w_emb (B, 256) or
    None -> eps (B, T, C_in)."""
    heads = c["num_heads"]
    temb = timestep_embedding(t)
    if w_emb is not None:
        temb = temb + ops.linear(p, w_emb, sd["t_embedder.proj_w.weight"])
    t_tok = ops.linear(p, F.silu(ops.linear(p, temb, sd["t_embedder.mlp.0.weight"],
                                            sd["t_embedder.mlp.0.bias"])),
                       sd["t_embedder.mlp.2.weight"], sd["t_embedder.mlp.2.bias"])
    c1, c2 = ctx.float().chunk(2, dim=1)
    cond = torch.cat([_cond_embed(p, c1, sd, "c1_embedder"), _cond_embed(p, c2, sd, "c2_embedder")],
                     dim=1)
    h = ops.conv1d(p, x.float().transpose(1, 2), sd["proj_in.weight"], sd["proj_in.bias"],
                   padding=2).transpose(1, 2)
    h = torch.cat([t_tok[:, None], cond, h], dim=1)
    h = h + _f(sd["pos_emb.weight"])[None, :h.shape[1]]
    for i in range(c["depth"]):
        pre, tb = f"blocks.{i}", f"blocks.{i}.transformer_blocks.0"
        ln = lambda y, n: ops.layer_norm(y, sd[f"{tb}.{n}.weight"], sd[f"{tb}.{n}.bias"], 1e-5)
        g = _conv1x1_cl(p, _gn_cl(h, 32, sd, f"{pre}.norm", 1e-6), sd, f"{pre}.proj_in")
        g = g + _self_attention(p, ln(g, "norm1"), sd, f"{tb}.attn1", heads)
        g = g + _self_attention(p, ln(g, "norm2"), sd, f"{tb}.attn2", heads)
        g = g + _geglu_ff(p, ln(g, "norm3"), sd, f"{tb}.ff")
        h = _conv1x1_cl(p, g, sd, f"{pre}.proj_out") + h
    h = _gn_cl(h[:, cond.shape[1] + 1:], 16, sd, "final_layer.norm_final", 1e-5)
    return _conv1x1_cl(p, h, sd, "final_layer.conv1d")


# ----------------------------------------------------------------- VAE

def _conv_cf(p, x, sd, name, k, stride=1, pad=None):
    return ops.conv1d(p, x, sd[f"{name}.weight"], sd[f"{name}.bias"], stride=stride,
                      padding=k // 2 if pad is None else pad)


def _resnet(p, x, sd, name, k):
    h = _conv_cf(p, F.silu(ops.group_norm(x, 32, sd[f"{name}.norm1.weight"],
                                          sd[f"{name}.norm1.bias"], 1e-6)), sd, f"{name}.conv1", k)
    h = _conv_cf(p, F.silu(ops.group_norm(h, 32, sd[f"{name}.norm2.weight"],
                                          sd[f"{name}.norm2.bias"], 1e-6)), sd, f"{name}.conv2", k)
    if f"{name}.nin_shortcut.weight" in sd:
        x = _conv_cf(p, x, sd, f"{name}.nin_shortcut", 1)
    return x + h


def _vae_attn(p, x, sd, name):
    h = ops.group_norm(x, 32, sd[f"{name}.norm.weight"], sd[f"{name}.norm.bias"], 1e-6)
    q, k, v = (_conv_cf(p, h, sd, f"{name}.{m}", 1) for m in "qkv")
    w = torch.softmax(ops.matmul(p, q.transpose(1, 2), k) * x.shape[1] ** -0.5, dim=-1)
    h = ops.matmul(p, w, v.transpose(1, 2)).transpose(1, 2)
    return x + _conv_cf(p, h, sd, f"{name}.proj_out", 1)


def _vae_mid(p, h, sd, name, k):
    h = _resnet(p, h, sd, f"{name}.block_1", k)
    return _resnet(p, _vae_attn(p, h, sd, f"{name}.attn_1"), sd, f"{name}.block_2", k)


def vae_decode(sd: dict, c: dict, z: torch.Tensor, p: ops.Precision = ops.F32) -> torch.Tensor:
    """latent (B, T, embed_dim) -> mel (B, 2T, out_ch)."""
    k, mult = c["kernel_size"], c["ch_mult"]
    up_layers = [i + 1 for i in c["down_layers"]]
    h = _conv_cf(p, z.float().transpose(1, 2), sd, "post_quant_conv", 1)
    h = _vae_mid(p, _conv_cf(p, h, sd, "decoder.conv_in", k), sd, "decoder.mid", 3)
    for i in reversed(range(len(mult))):
        for j in range(c["num_res_blocks"] + 1):
            h = _resnet(p, h, sd, f"decoder.up.{i}.block.{j}", 3)
        if i in up_layers:
            h = _conv_cf(p, torch.repeat_interleave(h, 2, dim=-1), sd,
                         f"decoder.up.{i}.upsample.conv", 3)
    h = F.silu(ops.group_norm(h, 32, sd["decoder.norm_out.weight"], sd["decoder.norm_out.bias"],
                              1e-6))
    return _conv_cf(p, h, sd, "decoder.conv_out", k).transpose(1, 2)


# ----------------------------------------------------------------- vocoder

def kaiser_sinc_filter(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """alias_free_torch's kaiser-windowed sinc lowpass (float64 -> float32)."""
    half = kernel_size // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    beta = (0.1102 * (a - 8.7) if a > 50.0 else
            0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0) if a >= 21.0 else 0.0)
    window = np.kaiser(kernel_size, beta)
    time = (np.arange(-half, half) + 0.5 if kernel_size % 2 == 0
            else np.arange(kernel_size) - half)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    return (filt / filt.sum()).astype(np.float32)


def _fir(x: torch.Tensor) -> torch.Tensor:
    f = torch.from_numpy(kaiser_sinc_filter(0.25, 0.3, 12)).to(x.device)
    return f.view(1, 1, -1).expand(x.shape[1], 1, -1)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T) -> (B, C, 2T): replicate pad 5, transposed depthwise conv
    with the filter times 2, crop 15 / 15."""
    xp = F.pad(x, (5, 5), mode="replicate")
    return (2 * F.conv_transpose1d(xp, _fir(x), stride=2, groups=x.shape[1]))[..., 15:-15]


def downsample2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, 2T) -> (B, C, T): replicate pad (5, 6), strided depthwise conv."""
    return F.conv1d(F.pad(x, (5, 6), mode="replicate"), _fir(x), stride=2, groups=x.shape[1])


def _snake_act(x, sd, name):
    a = torch.exp(_f(sd[f"{name}.act.alpha"]))[None, :, None]
    b = torch.exp(_f(sd[f"{name}.act.beta"]))[None, :, None]
    u = upsample2(x)
    u = u + 0.5 * (1.0 - torch.cos(2.0 * a * u)) / (b + 1e-9)
    return downsample2(u)


def vocoder(sd: dict, c: dict, mel: torch.Tensor, p: ops.Precision = ops.F32) -> torch.Tensor:
    """mel (B, T, num_mels) -> waveform (B, T * prod(upsample_rates))."""
    c0, kss = c["upsample_initial_channel"], c["resblock_kernel_sizes"]
    dss = c["resblock_dilation_sizes"]
    x = _conv_cf(p, mel.float().transpose(1, 2), sd, "conv_pre", 7)
    n = 0
    for i, (u, k) in enumerate(zip(c["upsample_rates"], c["upsample_kernel_sizes"])):
        x = ops.conv_transpose1d(p, x, sd[f"ups.{i}.0.weight"], sd[f"ups.{i}.0.bias"], u,
                                 (k - u) // 2)
        acc = 0.0
        for rk, rd in zip(kss, dss):
            y, pre = x, f"resblocks.{n}"
            for j, d in enumerate(rd):
                h = ops.conv1d(p, _snake_act(y, sd, f"{pre}.activations.{2 * j}"),
                               sd[f"{pre}.convs1.{j}.weight"], sd[f"{pre}.convs1.{j}.bias"],
                               padding=(rk * d - d) // 2, dilation=d)
                h = ops.conv1d(p, _snake_act(h, sd, f"{pre}.activations.{2 * j + 1}"),
                               sd[f"{pre}.convs2.{j}.weight"], sd[f"{pre}.convs2.{j}.bias"],
                               padding=(rk - 1) // 2)
                y = y + h
            acc = acc + y
            n += 1
        x = acc / len(kss)
    x = _conv_cf(p, _snake_act(x, sd, "activation_post"), sd, "conv_post", 7)
    return torch.tanh(x)[:, 0]
