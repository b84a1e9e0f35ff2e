"""Key and shape of every tensor of the five models' state dicts, in the
reference checkpoints' layout (HF BertModel under `base.` plus the CLAP
projection, HF T5EncoderModel, concatDiT.py's ConcatDiT2MLP,
autoencoder1d.py's AutoencoderKL, BigVGAN with weight norm removed), from
the sizes of a configuration file. The benchmark draws its random weights
into these shapes; the reference reads them by these names.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

Layout = List[Tuple[str, Tuple[int, ...]]]

FF_MULT, FF_KERNEL, FREQ_DIM = 4, 9, 256  # ConcatDiT2MLP's conv-GEGLU FF and timestep sinusoid


def _dense(out: Layout, name: str, d_out: int, d_in: int, bias: bool = True) -> None:
    out.append((f"{name}.weight", (d_out, d_in)))
    if bias:
        out.append((f"{name}.bias", (d_out,)))


def _conv(out: Layout, name: str, c_out: int, c_in: int, k: int) -> None:
    out.append((f"{name}.weight", (c_out, c_in, k)))
    out.append((f"{name}.bias", (c_out,)))


def _norm(out: Layout, name: str, d: int) -> None:
    out.append((f"{name}.weight", (d,)))
    out.append((f"{name}.bias", (d,)))


def clap_text(c: dict) -> Layout:
    d, out = c["hidden_size"], []
    e = "base.embeddings"
    out += [(f"{e}.word_embeddings.weight", (c["vocab_size"], d)),
            (f"{e}.position_embeddings.weight", (c["max_position_embeddings"], d)),
            (f"{e}.token_type_embeddings.weight", (c["type_vocab_size"], d))]
    _norm(out, f"{e}.LayerNorm", d)
    for i in range(c["num_layers"]):
        p = f"base.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            _dense(out, f"{p}.attention.self.{n}", d, d)
        _dense(out, f"{p}.attention.output.dense", d, d)
        _norm(out, f"{p}.attention.output.LayerNorm", d)
        _dense(out, f"{p}.intermediate.dense", c["intermediate_size"], d)
        _dense(out, f"{p}.output.dense", d, c["intermediate_size"])
        _norm(out, f"{p}.output.LayerNorm", d)
    _dense(out, "projection.linear1", c["d_proj"], d, bias=False)
    _dense(out, "projection.linear2", c["d_proj"], c["d_proj"], bias=False)
    _norm(out, "projection.layer_norm", c["d_proj"])
    return out


def t5(c: dict) -> Layout:
    d, inner, out = c["d_model"], c["num_heads"] * c["d_kv"], []
    out.append(("shared.weight", (c["vocab_size"], d)))
    for i in range(c["num_layers"]):
        p = f"encoder.block.{i}.layer"
        for n in ("q", "k", "v"):
            _dense(out, f"{p}.0.SelfAttention.{n}", inner, d, bias=False)
        _dense(out, f"{p}.0.SelfAttention.o", d, inner, bias=False)
        if i == 0:
            out.append((f"{p}.0.SelfAttention.relative_attention_bias.weight",
                        (c["relative_attention_num_buckets"], c["num_heads"])))
        out.append((f"{p}.0.layer_norm.weight", (d,)))
        for n in ("wi_0", "wi_1"):
            _dense(out, f"{p}.1.DenseReluDense.{n}", c["d_ff"], d, bias=False)
        _dense(out, f"{p}.1.DenseReluDense.wo", d, c["d_ff"], bias=False)
        out.append((f"{p}.1.layer_norm.weight", (d,)))
    out.append(("encoder.final_layer_norm.weight", (d,)))
    return out


def dit(c: dict) -> Layout:
    h, out = c["hidden_size"], []
    _dense(out, "t_embedder.mlp.0", h, FREQ_DIM)
    _dense(out, "t_embedder.mlp.2", h, h)
    _dense(out, "t_embedder.proj_w", FREQ_DIM, FREQ_DIM, bias=False)
    _conv(out, "proj_in", h, c["in_channels"], 5)
    out.append(("pos_emb.weight", (c["max_len"], h)))
    for i in range(c["depth"]):
        p = f"blocks.{i}"
        _norm(out, f"{p}.norm", h)
        _conv(out, f"{p}.proj_in", h, h, 1)
        tb = f"{p}.transformer_blocks.0"
        for a in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v"):
                _dense(out, f"{tb}.{a}.{n}", h, h, bias=False)
            _dense(out, f"{tb}.{a}.to_out.0", h, h)
        for n in ("norm1", "norm2", "norm3"):
            _norm(out, f"{tb}.{n}", h)
        _conv(out, f"{tb}.ff.net.0.proj", 2 * FF_MULT * h, h, FF_KERNEL)
        _conv(out, f"{tb}.ff.net.2", h, FF_MULT * h, FF_KERNEL)
        _conv(out, f"{p}.proj_out", h, h, 1)
    _norm(out, "final_layer.norm_final", h)
    _conv(out, "final_layer.conv1d", c["in_channels"], h, 1)
    for e in ("c1_embedder", "c2_embedder"):
        _dense(out, f"{e}.mlp.0", h, c["context_dim"])
        _dense(out, f"{e}.mlp.2", h, h)
        _norm(out, f"{e}.mlp.3", h)
    return out


def _resnet(out: Layout, name: str, cin: int, cout: int, k: int) -> None:
    _norm(out, f"{name}.norm1", cin)
    _conv(out, f"{name}.conv1", cout, cin, k)
    _norm(out, f"{name}.norm2", cout)
    _conv(out, f"{name}.conv2", cout, cout, k)
    if cin != cout:
        _conv(out, f"{name}.nin_shortcut", cout, cin, 1)


def _mid(out: Layout, name: str, c: int, k: int) -> None:
    _resnet(out, f"{name}.block_1", c, c, k)
    _norm(out, f"{name}.attn_1.norm", c)
    for n in ("q", "k", "v", "proj_out"):
        _conv(out, f"{name}.attn_1.{n}", c, c, 1)
    _resnet(out, f"{name}.block_2", c, c, k)


def vae(c: dict) -> Layout:
    """AutoencoderKL1D. attn_layers must name no level (the shipped [3]
    names none): only the mid-blocks attend."""
    k, ch, mult, out = c["kernel_size"], c["ch"], c["ch_mult"], []
    if any(0 <= i < len(mult) for i in c["attn_layers"]):
        raise ValueError("level attention is not in the reference")
    zc = 2 * c["z_channels"] if c["double_z"] else c["z_channels"]
    _conv(out, "encoder.conv_in", ch, c["in_channels"], k)
    block_in = ch
    for i, m in enumerate(mult):
        for j in range(c["num_res_blocks"]):
            _resnet(out, f"encoder.down.{i}.block.{j}", block_in if j == 0 else ch * m, ch * m, k)
        if i in c["down_layers"]:
            _conv(out, f"encoder.down.{i}.downsample.conv", ch * m, ch * m, 3)
        block_in = ch * m
    _mid(out, "encoder.mid", block_in, k)
    _norm(out, "encoder.norm_out", block_in)
    _conv(out, "encoder.conv_out", zc, block_in, k)
    up_layers = [i + 1 for i in c["down_layers"]]
    block_in = ch * mult[-1]
    _conv(out, "decoder.conv_in", block_in, c["z_channels"], k)
    _mid(out, "decoder.mid", block_in, 3)
    for i in reversed(range(len(mult))):
        block_out = ch * mult[i]
        for j in range(c["num_res_blocks"] + 1):
            _resnet(out, f"decoder.up.{i}.block.{j}", block_in if j == 0 else block_out,
                    block_out, 3)
        if i in up_layers:
            _conv(out, f"decoder.up.{i}.upsample.conv", block_out, block_out, 3)
        block_in = block_out
    _norm(out, "decoder.norm_out", block_in)
    _conv(out, "decoder.conv_out", c["out_ch"], block_in, k)
    _conv(out, "quant_conv", 2 * c["embed_dim"], zc, 1)
    _conv(out, "post_quant_conv", c["z_channels"], c["embed_dim"], 1)
    return out


def vocoder(c: dict) -> Layout:
    """BigVGAN generator, resblock "1", snake-beta activations."""
    if c["resblock"] != "1" or c["activation"] != "snakebeta":
        raise ValueError("the reference has BigVGAN's resblock '1' with snakebeta only")
    c0, out = c["upsample_initial_channel"], []
    _conv(out, "conv_pre", c0, c["num_mels"], 7)
    n = 0
    for i, k in enumerate(c["upsample_kernel_sizes"]):
        cin, ch = c0 // 2 ** i, c0 // 2 ** (i + 1)
        out += [(f"ups.{i}.0.weight", (cin, ch, k)), (f"ups.{i}.0.bias", (ch,))]
        for rk, rd in zip(c["resblock_kernel_sizes"], c["resblock_dilation_sizes"]):
            for j in range(len(rd)):
                _conv(out, f"resblocks.{n}.convs1.{j}", ch, ch, rk)
                _conv(out, f"resblocks.{n}.convs2.{j}", ch, ch, rk)
            for j in range(2 * len(rd)):
                out += [(f"resblocks.{n}.activations.{j}.act.alpha", (ch,)),
                        (f"resblocks.{n}.activations.{j}.act.beta", (ch,))]
            n += 1
    ch = c0 // 2 ** len(c["upsample_rates"])
    out += [("activation_post.act.alpha", (ch,)), ("activation_post.act.beta", (ch,))]
    _conv(out, "conv_post", 1, ch, 7)
    return out


MODELS = {"clap_text": clap_text, "t5": t5, "dit": dit, "vae": vae, "vocoder": vocoder}


def layouts(config: dict) -> Dict[str, Layout]:
    """{model: [(key, shape)]} for the five models of a configuration."""
    return {name: fn(config[name]) for name, fn in MODELS.items()}
