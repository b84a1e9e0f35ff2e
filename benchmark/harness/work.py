"""The yardstick: the work the model's mathematics needs at a request's
shapes, and the card's published peaks.

FLOP are 2 x the multiply-adds of every matrix product and convolution the
published architecture computes: dense attention over all T^2 pairs, every
conv at its full kernel, the depthwise anti-alias filters of BigVGAN's
activations; not the element-wise work (norms, activations, softmax), which
is a few per cent of it. They do not depend on how the program computes:
a later kernel that skips work leaves these counts as they are.

The K1 and K3 bounds are copies of the port's smoke script's
`stage_bound_ms` and `flash_bound_ms`: the larger of the bytes (inputs read
once, outputs written once) over the HBM rate and the operations over the
bf16 peak.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAKS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bert_flop(c: dict, batch: int, tok: int) -> float:
    d, ff = c["hidden_size"], c["intermediate_size"]
    per_token = c["num_layers"] * (4 * d * d + 2 * d * ff + 2 * tok * d)
    per_token += d * c["d_proj"] + c["d_proj"] ** 2
    return 2.0 * batch * tok * per_token


def t5_flop(c: dict, batch: int, tok: int) -> float:
    d, inner, ff = c["d_model"], c["num_heads"] * c["d_kv"], c["d_ff"]
    return 2.0 * batch * tok * c["num_layers"] * (4 * d * inner + 3 * d * ff + 2 * tok * inner)


def text_flop(config: dict, batch: int, tok: int) -> float:
    return bert_flop(config["clap_text"], batch, tok) + t5_flop(config["t5"], batch, tok)


def dit_flop(c: dict, batch: int, latent: int, ctx_tokens: int, w_embed: bool) -> float:
    """One ConcatDiT2MLP forward: the embedders, proj_in, per block the 1x1
    in / out, two self-attentions (projections and QK^T, PV) and the
    kernel-9 conv-GEGLU FF (d -> 8d, 4d -> d), the head."""
    h, cin, ctx = c["hidden_size"], c["in_channels"], c["context_dim"]
    seq = 1 + ctx_tokens + latent
    macs = (256 * 256 if w_embed else 0) + 256 * h + h * h
    macs += ctx_tokens * (ctx * h + h * h)
    macs += latent * 5 * cin * h
    macs += c["depth"] * seq * (2 * h * h + 2 * (4 * h * h + 2 * seq * h) + 9 * h * 8 * h
                                + 9 * 4 * h * h)
    macs += latent * h * cin
    return 2.0 * batch * macs


def _resnet_macs(t: int, cin: int, cout: int, k: int) -> int:
    return t * (cin * cout * k + cout * cout * k + (cin * cout if cin != cout else 0))


def _mid_macs(t: int, c: int, k: int) -> int:
    return 2 * _resnet_macs(t, c, c, k) + t * 4 * c * c + 2 * t * t * c


def vae_decode_flop(c: dict, batch: int, latent: int) -> float:
    ch, mult, k, z = c["ch"], c["ch_mult"], c["kernel_size"], c["z_channels"]
    up_layers = [i + 1 for i in c["down_layers"]]
    t, block_in = latent, ch * mult[-1]
    macs = t * c["embed_dim"] * z + t * z * block_in * k + _mid_macs(t, block_in, 3)
    for i in reversed(range(len(mult))):
        out = ch * mult[i]
        for j in range(c["num_res_blocks"] + 1):
            macs += _resnet_macs(t, block_in if j == 0 else out, out, 3)
        if i in up_layers:
            t *= 2
            macs += t * out * out * 3
        block_in = out
    macs += t * block_in * c["out_ch"] * k
    return 2.0 * batch * macs


def vocoder_stages(c: dict, mel_len: int):
    """[(channels, samples after the stage's upsampling)] per stage."""
    out, t = [], mel_len
    for i, u in enumerate(c["upsample_rates"]):
        t *= u
        out.append((c["upsample_initial_channel"] // 2 ** (i + 1), t))
    return out


ACT_MACS = 24  # per sample and channel: the 12-tap up filter and the 12-tap down filter


def vocoder_flop(c: dict, batch: int, mel_len: int) -> float:
    c0, ks = c["upsample_initial_channel"], c["resblock_kernel_sizes"]
    macs = mel_len * c["num_mels"] * c0 * 7
    t_in, cin = mel_len, c0
    for (ch, t), k in zip(vocoder_stages(c, mel_len), c["upsample_kernel_sizes"]):
        macs += t_in * cin * ch * k
        for rk, rd in zip(ks, c["resblock_dilation_sizes"]):
            macs += len(rd) * 2 * (t * ch * ch * rk + ACT_MACS * t * ch)
        t_in, cin = t, ch
    macs += ACT_MACS * t_in * cin + t_in * cin * 7
    return 2.0 * batch * macs


def request_flop(config: dict, batch: int, mel_len: int, tok: int) -> float:
    """The whole generate of one request: text towers, the sampler's DiT
    forwards, the VAE decode and the vocoder."""
    s, latent, ctx_tokens = config["sampler"], mel_len // 2, 2 * tok
    if s["kind"] == "lcm":
        text = text_flop(config, batch, tok)
        dit = s["num_inference_steps"] * dit_flop(config["dit"], batch, latent, ctx_tokens, True)
    else:  # prompt and the empty prompt at batch 1; guidance doubles the DiT batch
        text = text_flop(config, batch, tok) + text_flop(config, 1, tok)
        dit = s["num_steps"] * dit_flop(config["dit"], 2 * batch, latent, ctx_tokens, False)
    return (text + dit + vae_decode_flop(config["vae"], batch, latent)
            + vocoder_flop(config["vocoder"], batch, mel_len))


def stage_bound_s(b: int, t: int, c: int, elem_bytes: int, kernel_sizes=(3, 7, 11),
                  dilations=(1, 3, 5)) -> float:
    """Least time of one fused AMP stage (three resblocks of three
    dilation sub-units): x read once, out written once, conv weights,
    biases and snake parameters once, over the HBM rate, against the convs'
    252 C^2 and the 18 activations' ~60 C FLOP per sample over the bf16
    peak."""
    n, n_sub = b * t, len(kernel_sizes) * len(dilations)
    weights = 2 * len(dilations) * sum(kernel_sizes) * c * c + 6 * n_sub * c
    t_bytes = (2 * n * c + weights) * elem_bytes / HBM_BYTES_PER_S
    conv_flop = 2 * 2 * len(dilations) * sum(kernel_sizes) * c * c  # 252 C^2 at (3, 7, 11)
    t_ops = (conv_flop + 18 * 60 * c) * n / PEAKS["bfloat16"]
    return max(t_bytes, t_ops)


def fused_stages_bound_s(config: dict, batch: int, mel_len: int) -> float:
    """K1's bound for one request: every vocoder stage at or under the
    configuration's `pallas_stage_max_channels`."""
    cmax = config["serving"]["pallas_stage_max_channels"]
    c = config["vocoder"]
    return sum(stage_bound_s(batch, t, ch, 2, c["resblock_kernel_sizes"],
                             c["resblock_dilation_sizes"][0])
               for ch, t in vocoder_stages(c, mel_len) if ch <= cmax)


def flash_bound_s(b: int, h: int, t: int, d: int, elem_bytes: int = 2) -> float:
    """Least time of one attention: q, k, v read and out written once, against
    4 B H T^2 D FLOP (QK^T and PV) over the bf16 peak."""
    return max(4 * b * h * t * d * elem_bytes / HBM_BYTES_PER_S,
               4 * b * h * t * t * d / PEAKS["bfloat16"])


def self_attention_bound_s(config: dict, batch: int, mel_len: int, tok: int) -> float:
    """K3's bound for one teacher request: every DiT self-attention of every
    DDIM step, at the guidance-doubled batch."""
    c, s = config["dit"], config["sampler"]
    seq = 1 + 2 * tok + mel_len // 2
    per = flash_bound_s(2 * batch, c["num_heads"], seq, c["hidden_size"] // c["num_heads"])
    return s["num_steps"] * c["depth"] * 2 * per
