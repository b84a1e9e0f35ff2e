"""The yardstick of the Flag-DiT teacher (`flagdit_2b_teacher`), as
`work.py` is the ConcatDiT's: the FLOP of every matrix product of a
TxtFlagLargeDiT forward and of the whole teacher request, and K3's bound
over the denoiser's self- and cross-attentions. The shared models' counts
and the card's peaks are `work.py`'s.
"""

from __future__ import annotations

from benchmark.harness import work
from benchmark.reference.flag_dit import ffn_hidden
from benchmark.reference.layout import FREQ_DIM


def flag_dit_flop(c: dict, batch: int, latent: int, ctx_tokens: int) -> float:
    """One TxtFlagLargeDiT forward: per sample the timestep MLP, the pooled
    caption's projection and every adaLN linear; per latent token proj_in,
    the head and per block Wq, Wk, Wv, Wo, the attentions over all T^2 and
    T x Lc pairs and the SwiGLU; per caption token per block Wk_y and Wv_y."""
    d, cin, ctx = c["hidden_size"], c["in_channels"], c["context_dim"]
    kv = (c.get("n_kv_heads") or c["num_heads"]) * (d // c["num_heads"])
    per_sample = FREQ_DIM * d + d * d + ctx * d + c["depth"] * 6 * d * d + 2 * d * d
    per_block = (latent * (2 * d * d + 2 * d * kv + 2 * latent * d + 2 * ctx_tokens * d
                           + 3 * d * ffn_hidden(c))
                 + ctx_tokens * 2 * ctx * kv)
    macs = per_sample + latent * (cin * d + d * cin) + c["depth"] * per_block
    return 2.0 * batch * macs


def caption_flop(c: dict, batch: int, ctx_tokens: int) -> float:
    """The part of `flag_dit_flop` that reads the caption alone: the pooled
    caption's projection and per block Wk_y and Wv_y over its tokens."""
    d, ctx = c["hidden_size"], c["context_dim"]
    kv = (c.get("n_kv_heads") or c["num_heads"]) * (d // c["num_heads"])
    return 2.0 * batch * (ctx * d + c["depth"] * ctx_tokens * 2 * ctx * kv)


def request_flop(config: dict, batch: int, mel_len: int, tok: int) -> float:
    """One teacher request: the text towers for the prompts and the empty
    prompt (batch 1), `num_steps` guidance-doubled forwards, of which the
    caption's part once (the program keeps it over the steps,
    `TxtFlagLargeDiT.caption_memo`), the VAE decode and the vocoder."""
    latent, steps = mel_len // 2, config["sampler"]["num_steps"]
    c = config["dit"]
    return (work.text_flop(config, batch, tok) + work.text_flop(config, 1, tok)
            + steps * flag_dit_flop(c, 2 * batch, latent, 2 * tok)
            - (steps - 1) * caption_flop(c, 2 * batch, 2 * tok)
            + work.vae_decode_flop(config["vae"], batch, latent)
            + work.vocoder_flop(config["vocoder"], batch, mel_len))


def k3_bound_s(b: int, h: int, tq: int, tk: int, d: int, elem_bytes: int = 2) -> float:
    """Least time of one K3 launch: q and out (B, H, Tq, D), k and v (B, H,
    Tk, D) each read or written once over the HBM rate, against 4 B H Tq Tk D
    FLOP (QK^T and PV) over the bf16 peak."""
    return max(elem_bytes * b * h * d * (2 * tq + 2 * tk) / work.HBM_BYTES_PER_S,
               4 * b * h * tq * tk * d / work.PEAKS["bfloat16"])


def attention_bound_s(config: dict, batch: int, mel_len: int, tok: int) -> float:
    """K3's bound for one teacher request: per DDIM step and block, the
    self-attention over the latent and the caption branch over its 2 tok
    keys, at the guidance-doubled batch."""
    c, latent = config["dit"], mel_len // 2
    h, hd = c["num_heads"], c["hidden_size"] // c["num_heads"]
    per_block = (k3_bound_s(2 * batch, h, latent, latent, hd)
                 + k3_bound_s(2 * batch, h, latent, 2 * tok, hd))
    return config["sampler"]["num_steps"] * c["depth"] * per_block
