"""The yardstick of the caption-LLM configuration (`audiolcm_moonlight16b`),
as `work.py` is the student's: the FLOP of every matrix product of the
DeepSeek-V3-family tower and of the DiT with its third condition embedder,
a whole request's, and K7's bound. The shared models' counts and the
card's peaks are `work.py`'s. The tower's keys are the configuration's
top-level keys (the model's config.json).
"""

from __future__ import annotations

from benchmark.harness import work


def _moe_layers(c: dict) -> int:
    return sum(i >= c["first_k_dense_replace"] and i % c["moe_layer_freq"] == 0
               for i in range(c["num_hidden_layers"]))


def llm_flop(c: dict, batch: int, tok: int) -> float:
    """One tower forward over (batch, tok) ids: per token and layer the MLA
    projections (q, kv_a, kv_b, o) and its scores and values over all tok
    keys (the causal mask's zeros included, as the reference computes
    them); the dense SwiGLU in the leading layers; in each expert layer
    the router, num_experts_per_tok routed SwiGLUs and the shared one."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    qk, rope = c["qk_nope_head_dim"] + c["qk_rope_head_dim"], c["qk_rope_head_dim"]
    attn = (d * h * qk + d * (c["kv_lora_rank"] + rope)
            + c["kv_lora_rank"] * h * (c["qk_nope_head_dim"] + c["v_head_dim"])
            + h * c["v_head_dim"] * d + tok * h * (qk + c["v_head_dim"]))
    n_moe = _moe_layers(c)
    moe = (d * c["n_routed_experts"] + 3 * d * c["moe_intermediate_size"]
           * (c["num_experts_per_tok"] + c["n_shared_experts"]))
    dense = 3 * d * c["intermediate_size"]
    macs = c["num_hidden_layers"] * attn + n_moe * moe + (c["num_hidden_layers"] - n_moe) * dense
    return 2.0 * batch * tok * macs


def dit_flop(dc: dict, batch: int, latent: int, tok: int, llm_tok: int) -> float:
    """One ConcatDiT2MLP forward (`work.dit_flop`, with its w-embedding) over
    2 tok + llm_tok condition tokens, the LLM's through their embedder's
    wider first linear (llm_context_dim in, not context_dim)."""
    extra = llm_tok * (dc["llm_context_dim"] - dc["context_dim"]) * dc["hidden_size"]
    return work.dit_flop(dc, batch, latent, 2 * tok + llm_tok, True) + 2.0 * batch * extra


def request_flop(config: dict, batch: int, mel_len: int, tok: int, llm_tok: int) -> float:
    """One request: CLAP and T5, the tower, the LCM steps' DiT forwards
    (282 condition tokens at 77 + 77 + 128), the VAE decode, the vocoder."""
    latent, steps = mel_len // 2, config["sampler"]["num_inference_steps"]
    return (work.text_flop(config, batch, tok) + llm_flop(config, batch, llm_tok)
            + steps * dit_flop(config["dit"], batch, latent, tok, llm_tok)
            + work.vae_decode_flop(config["vae"], batch, latent)
            + work.vocoder_flop(config["vocoder"], batch, mel_len))


def k7_bytes(c: dict, tokens: int, elem_bytes: int = 2) -> float:
    """What K7 reads and writes in one forward over `tokens` tokens: every
    routed expert's weights, each counted as read (under uniform routing,
    at 128 tokens x 6 choices, the odds that an expert of 64 gets no token
    are ~2e-4 a layer; a router as uneven as the benchmark's random tower
    leaves some experts idle, whose weights K7 does not read), and per
    token its input, the residual and the shared experts' output read and
    the layer's output written, in every expert layer."""
    weights = c["n_routed_experts"] * 3 * c["hidden_size"] * c["moe_intermediate_size"]
    return _moe_layers(c) * elem_bytes * (weights + 4 * tokens * c["hidden_size"])


def k7_flop(c: dict, tokens: int) -> float:
    """The routed SwiGLUs' products: num_experts_per_tok per token and layer."""
    return (_moe_layers(c) * 2.0 * tokens * c["num_experts_per_tok"] * 3 * c["hidden_size"]
            * c["moe_intermediate_size"])


def k7_bound_s(c: dict, tokens: int) -> float:
    """K7's least time over one forward: the larger of its bytes at the HBM
    rate and its FLOP at the bf16 peak (the bytes, by ~25x at 128 tokens)."""
    return max(k7_bytes(c, tokens) / work.HBM_BYTES_PER_S,
               k7_flop(c, tokens) / work.PEAKS["bfloat16"])
