"""Checkpoint loading for the port, and weights carried over from the JAX
package.

The port's modules keep the reference PyTorch state-dict layout, so a
reference checkpoint loads with `load_state_dict` + `assign_state_dict`
(after `fold_weight_norms` for the vocoder). `from_jax` turns the JAX
package's parameter trees (numpy leaves) back into that layout:

  Dense kernel (in, out)           -> Linear weight (out, in)
  Conv kernel (k..., in, out)      -> Conv1d / Conv2d weight (out, in, k...)
  ConvTranspose1dTorchParity       -> ConvTranspose1d weight (in, out, k)
    kernel (k, in, out), k flipped    (time flip undone)
  GroupNorm/LayerNorm scale        -> weight
  snake alpha/beta                 -> as stored (log scale)
  fused Q/K/V, T5 gated-FF pairs   -> split back into the separate tensors

The variant models: `dit_from_jax` also takes ConcatDiT and the order
DiTs, `vae_from_jax` the 2D KL and VQ VAEs; `flag_dit_from_jax` and
`text_transformer_from_jax` keep the JAX trees' names (their modules have
no reference converter); `xtransformer_from_jax` writes the reference
`TransformerWrapper` layout that a reference checkpoint loads into
directly.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

SD = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# reference checkpoint files
# ---------------------------------------------------------------------------


def load_state_dict(path: str, key: Optional[str] = "auto") -> SD:
    """Load a torch checkpoint file to a flat {name: tensor} dict on the CPU.
    key="auto" unwraps 'state_dict', 'model' or 'generator'."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if key == "auto":
        for k in ("state_dict", "model", "generator"):
            if isinstance(obj, dict) and isinstance(obj.get(k), dict):
                obj = obj[k]
                break
    elif key is not None:
        obj = obj[key]
    return {k: v.detach() for k, v in obj.items() if isinstance(v, torch.Tensor)}


def strip_prefix(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def split_lcm_state_dict(sd: SD) -> dict:
    """Split an LCM_audio Lightning state dict into per-model dicts: teacher
    (`model.diffusion_model.`), student (`unet.diffusion_model.`, used at
    inference), target, vae, clap (caption encoder), t5, and scale_factor."""
    out: dict = {
        "teacher": strip_prefix(sd, "model.diffusion_model."),
        "student": strip_prefix(sd, "unet.diffusion_model."),
        "target": strip_prefix(sd, "target_unet.diffusion_model."),
        "vae": strip_prefix(sd, "first_stage_model."),
        "clap": strip_prefix(sd, "cond_stage_model.caption_encoder."),
        "t5": strip_prefix(sd, "cond_stage_model.t5_transformer."),
    }
    out["scale_factor"] = float(sd["scale_factor"]) if "scale_factor" in sd else 1.0
    return out


def load_vocoder_dir(ckpt_dir: str):
    """(state_dict, args dict) from a reference vocoder directory
    (best_netG.pt['generator'] + args.yml)."""
    import yaml

    sd = load_state_dict(os.path.join(ckpt_dir, "best_netG.pt"), key="generator")
    with open(os.path.join(ckpt_dir, "args.yml")) as f:
        return sd, yaml.safe_load(f)


def fold_weight_norm(sd: dict, prefix: str) -> torch.Tensor:
    """Fold `<prefix>.weight_g`/`weight_v` into a plain weight (norm over
    every dim but the first)."""
    g, v = torch.as_tensor(sd[f"{prefix}.weight_g"]), torch.as_tensor(sd[f"{prefix}.weight_v"])
    norm = v.reshape(v.shape[0], -1).norm(dim=1).reshape((-1,) + (1,) * (v.dim() - 1))
    return g * v / norm.clamp_min(1e-12)


def fold_weight_norms(sd: dict) -> dict:
    """Every weight_g/weight_v pair of a state dict folded into `.weight`."""
    out = {k: v for k, v in sd.items() if not k.endswith((".weight_g", ".weight_v"))}
    for k in sd:
        if k.endswith(".weight_g"):
            prefix = k[: -len(".weight_g")]
            out[f"{prefix}.weight"] = fold_weight_norm(sd, prefix)
    return out


def assign_state_dict(module: nn.Module, sd: dict) -> nn.Module:
    """Copy a reference-layout state dict into `module` (its device and
    dtype). Every tensor the module has must be present with its shape;
    keys the module does not have are ignored (e.g. the other models of an
    LCM checkpoint)."""
    own = module.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"{type(module).__name__}: state dict lacks {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''}")
    module.load_state_dict({k: torch.as_tensor(sd[k]) for k in own}, strict=True)
    return module


# ---------------------------------------------------------------------------
# JAX parameter trees -> reference layout
# ---------------------------------------------------------------------------


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(p: dict, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _t(p["kernel"]).T.contiguous()
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _split_dense(p: dict, names, out: dict) -> None:
    """A fused Dense (kernel (in, n*w)) -> n Linear weights."""
    n = len(names)
    for i, (k, name) in enumerate(zip(np.split(np.asarray(p["kernel"]), n, axis=1), names)):
        sub = {"kernel": k}
        if "bias" in p:
            sub["bias"] = np.split(np.asarray(p["bias"]), n)[i]
        _dense(sub, name, out)


def _conv(p: dict, name: str, out: dict) -> None:
    """Conv kernel (k..., in, out) -> Conv1d / Conv2d weight (out, in, k...)."""
    k = np.asarray(p["kernel"], np.float32)
    perm = (k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2))
    out[f"{name}.weight"] = _t(np.transpose(k, perm)).contiguous()
    out[f"{name}.bias"] = _t(p["bias"])


def _conv1x1(p: dict, name: str, out: dict) -> None:
    """Dense standing in for a (out, in, 1) Conv1d."""
    _dense(p, name, out)
    out[f"{name}.weight"] = out[f"{name}.weight"][:, :, None]


def _norm(p: dict, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _attention(p: dict, name: str, out: dict) -> None:
    if "to_qkv" in p:
        _split_dense(p["to_qkv"], [f"{name}.to_{n}" for n in "qkv"], out)
    else:
        for n in "qkv":
            _dense(p[f"to_{n}"], f"{name}.to_{n}", out)
    _dense(p["to_out"], f"{name}.to_out.0", out)


def dit_from_jax(p: dict) -> SD:
    """ConcatDiT2MLP, ConcatDiT, ConcatOrderDiT and ConcatOrderDiT2 (the
    condition embedders and the order embedding each has)."""
    out: SD = {}
    te = p["t_embedder"]
    _dense(te["mlp_0"], "t_embedder.mlp.0", out)
    _dense(te["mlp_2"], "t_embedder.mlp.2", out)
    _dense(te["proj_w"], "t_embedder.proj_w", out)
    if "order_embedding" in p:
        out["order_embedding.weight"] = _t(p["order_embedding"]["embedding"])
    for c in ("c1_embedder", "c2_embedder", "c_embedder"):
        if c not in p:
            continue
        _dense(p[c]["mlp_0"], f"{c}.mlp.0", out)
        _dense(p[c]["mlp_2"], f"{c}.mlp.2", out)
        _norm(p[c]["mlp_3"], f"{c}.mlp.3", out)
    _conv(p["proj_in"], "proj_in", out)
    out["pos_emb.weight"] = _t(p["pos_emb"])
    _norm(p["final_norm"], "final_layer.norm_final", out)
    _conv1x1(p["final_conv"], "final_layer.conv1d", out)
    for key in p:
        m = re.fullmatch(r"blocks_(\d+)", key)
        if not m:
            continue
        b, name = p[key], f"blocks.{m.group(1)}"
        _norm(b["norm"], f"{name}.norm", out)
        _conv1x1(b["proj_in"], f"{name}.proj_in", out)
        _conv1x1(b["proj_out"], f"{name}.proj_out", out)
        blk, t = b["block_0"], f"{name}.transformer_blocks.0"
        _attention(blk["attn1"], f"{t}.attn1", out)
        _attention(blk["attn2"], f"{t}.attn2", out)
        for n in ("norm1", "norm2", "norm3"):
            _norm(blk[n], f"{t}.{n}", out)
        _conv(blk["ff"]["proj"], f"{t}.ff.net.0.proj", out)
        _conv(blk["ff"]["out"], f"{t}.ff.net.2", out)
    return out


def _resblock(p: dict, name: str, out: dict) -> None:
    for n in ("norm1", "norm2"):
        _norm(p[n], f"{name}.{n}", out)
    for n in ("conv1", "conv2", "nin_shortcut"):
        if n in p:
            _conv(p[n], f"{name}.{n}", out)


def _attnblock(p: dict, name: str, out: dict) -> None:
    _norm(p["norm"], f"{name}.norm", out)
    for n in ("q", "k", "v", "proj_out"):
        _conv(p[n], f"{name}.{n}", out)


def vae_from_jax(p: dict) -> SD:
    """Both halves of the VAE with their quant convs: the 1D VAE, the 2D KL
    VAE, and the 2D VQ model with its codebook."""
    out: SD = {}
    if "quantize" in p:
        out["quantize.embedding.weight"] = _t(p["quantize"]["embedding"])
    _conv(p["quant_conv"], "quant_conv", out)
    _conv(p["post_quant_conv"], "post_quant_conv", out)
    enc = p["encoder"]
    for n in ("conv_in", "conv_out"):
        _conv(enc[n], f"encoder.{n}", out)
    _norm(enc["norm_out"], "encoder.norm_out", out)
    _resblock(enc["mid_block_1"], "encoder.mid.block_1", out)
    _attnblock(enc["mid_attn_1"], "encoder.mid.attn_1", out)
    _resblock(enc["mid_block_2"], "encoder.mid.block_2", out)
    for key, sub in enc.items():
        if m := re.fullmatch(r"down_(\d+)_block_(\d+)", key):
            _resblock(sub, f"encoder.down.{m.group(1)}.block.{m.group(2)}", out)
        elif m := re.fullmatch(r"down_(\d+)_attn_(\d+)", key):
            _attnblock(sub, f"encoder.down.{m.group(1)}.attn.{m.group(2)}", out)
        elif m := re.fullmatch(r"down_(\d+)_downsample", key):
            _conv(sub["conv"], f"encoder.down.{m.group(1)}.downsample.conv", out)
    dec = p["decoder"]
    _conv(dec["conv_in"], "decoder.conv_in", out)
    _conv(dec["conv_out"], "decoder.conv_out", out)
    _norm(dec["norm_out"], "decoder.norm_out", out)
    _resblock(dec["mid_block_1"], "decoder.mid.block_1", out)
    _attnblock(dec["mid_attn_1"], "decoder.mid.attn_1", out)
    _resblock(dec["mid_block_2"], "decoder.mid.block_2", out)
    for key, sub in dec.items():
        if m := re.fullmatch(r"up_(\d+)_block_(\d+)", key):
            _resblock(sub, f"decoder.up.{m.group(1)}.block.{m.group(2)}", out)
        elif m := re.fullmatch(r"up_(\d+)_attn_(\d+)", key):
            _attnblock(sub, f"decoder.up.{m.group(1)}.attn.{m.group(2)}", out)
        elif m := re.fullmatch(r"up_(\d+)_upsample", key):
            _conv(sub["conv"], f"decoder.up.{m.group(1)}.upsample.conv", out)
    return out


def flag_dit_from_jax(p: dict) -> SD:
    """TxtFlagLargeDiT: the JAX tree's names, dotted (blocks_<i> ->
    blocks.<i>; Dense kernels transposed, LayerNorm scales to weights)."""
    out: SD = {}
    for name in ("proj_in", "t_mlp_0", "t_mlp_2", "cap_proj", "final_adaLN", "final_linear"):
        _dense(p[name], name, out)
    _norm(p["cap_norm"], "cap_norm", out)
    for key, blk in p.items():
        if not (m := re.fullmatch(r"blocks_(\d+)", key)):
            continue
        b = f"blocks.{m.group(1)}"
        _dense(blk["adaLN_modulation"], f"{b}.adaLN_modulation", out)
        for n in ("attention_y_norm", "attention_norm", "ffn_norm"):
            out[f"{b}.{n}.weight"] = _t(blk[n]["weight"])
        for n, sub in blk["attention"].items():
            if n == "gate":
                out[f"{b}.attention.gate"] = _t(sub)
            elif n.endswith("_norm"):
                _norm(sub, f"{b}.attention.{n}", out)
            else:
                _dense(sub, f"{b}.attention.{n}", out)
        for n in ("w1", "w2", "w3"):
            _dense(blk["feed_forward"][n], f"{b}.feed_forward.{n}", out)
    return out


def text_transformer_from_jax(p: dict) -> SD:
    """TransformerTextEncoder: attn_<i>, norm1_<i>, ... -> layers.<i>.*."""
    out: SD = {"token_emb.weight": _t(p["token_emb"]["embedding"]),
               "pos_emb": _t(p["pos_emb"])}
    _norm(p["final_norm"], "final_norm", out)
    for key, sub in p.items():
        if not (m := re.fullmatch(r"(attn|norm1|norm2|ff_in|ff_out)_(\d+)", key)):
            continue
        name = f"layers.{m.group(2)}.{m.group(1)}"
        if m.group(1) == "attn":
            _attention(sub, name, out)
        elif m.group(1).startswith("norm"):
            _norm(sub, name, out)
        else:
            _dense(sub, name, out)
    return out


def xtransformer_from_jax(p: dict, encoder) -> SD:
    """The JAX XTransformerWrapper's parameters -> the reference
    `TransformerWrapper` state dict (the inverse of the JAX package's
    `convert.xtransformer.convert_wrapper`). `encoder` is the port's
    XTransformerEncoder of the same options (its layer types and flags)."""
    out: SD = {"token_emb.weight": _t(p["token_emb"])}
    if "pos_emb" in p:
        out["pos_emb.emb.weight"] = _t(p["pos_emb"])
    for name in ("project_emb", "to_logits"):
        if name in p:
            _dense(p[name], name, out)
    if "memory_tokens" in p:
        out["memory_tokens"] = _t(p["memory_tokens"])
    _norm(p["final_norm"], "norm", out)
    e = p["encoder"]
    for i, kind in enumerate(encoder.layer_types):
        base = f"attn_layers.layers.{i}"
        norm = e.get(f"norm_{i}")
        if norm is None:
            # no norm (ReZero), or post-norm's last layer, which never applies
            # its norm: JAX has none, the reference module its init
            for k, v in encoder.layers[i][0].state_dict().items():
                out[f"{base}.0.{k}"] = v.detach().clone()
        elif "g" in norm:
            out[f"{base}.0.g"] = _t(norm["g"])
        else:
            _norm(norm, f"{base}.0", out)
        if kind in ("a", "c"):
            inner = f"{base}.1.fn" if encoder.use_rezero else f"{base}.1"
            a = e[f"attn_{i}"]
            for n in ("to_q", "to_k", "to_v"):
                _dense(a[n], f"{inner}.{n}", out)
            _dense(a["to_out"], f"{inner}.to_out.0" if encoder.on_attn else f"{inner}.to_out",
                   out)
            for n in ("pre_softmax_proj", "post_softmax_proj", "mem_k", "mem_v"):
                if n in a:
                    out[f"{inner}.{n}"] = _t(a[n])
            if encoder.use_rezero:
                out[f"{base}.1.g"] = _t(e[f"rezero_g_{i}"])
        else:
            inner = f"{base}.1.fn" if encoder.macaron else f"{base}.1"
            ff = e[f"ff_{i}"]
            _dense(ff["proj_in"], f"{inner}.net.0.proj" if encoder.ff_glu else f"{inner}.net.0.0",
                   out)
            _dense(ff["proj_out"], f"{inner}.net.2", out)
        if f"gate_{i}" in e:
            for n, v in e[f"gate_{i}"].items():
                out[f"{base}.2.gru.{n}"] = _t(v)
    return out


def _snake(p: dict, name: str, out: dict) -> None:
    for n in ("alpha", "beta"):
        if n in p:
            out[f"{name}.act.{n}"] = _t(p[n])


def vocoder_from_jax(p: dict) -> SD:
    out: SD = {}
    _conv(p["conv_pre"], "conv_pre", out)
    _conv(p["conv_post"], "conv_post", out)
    _snake(p["act_post"], "activation_post", out)
    nk = len([k for k in p if re.fullmatch(r"resblock_0_\d+", k)])
    for key, sub in p.items():
        if m := re.fullmatch(r"ups_(\d+)", key):
            k = np.asarray(sub["kernel"], np.float32)[::-1]  # (k, in, out), time flipped
            out[f"ups.{m.group(1)}.0.weight"] = _t(np.transpose(k, (1, 2, 0)))
            out[f"ups.{m.group(1)}.0.bias"] = _t(sub["bias"])
        elif m := re.fullmatch(r"resblock_(\d+)_(\d+)", key):
            r = f"resblocks.{int(m.group(1)) * nk + int(m.group(2))}"
            for name, val in sub.items():
                if mm := re.fullmatch(r"conv([12])_(\d+)", name):
                    _conv(val, f"{r}.convs{mm.group(1)}.{mm.group(2)}", out)
                elif mm := re.fullmatch(r"act([12])_(\d+)", name):
                    idx = 2 * int(mm.group(2)) + int(mm.group(1)) - 1
                    _snake(val, f"{r}.activations.{idx}", out)
                elif mm := re.fullmatch(r"conv_(\d+)", name):
                    _conv(val, f"{r}.convs.{mm.group(1)}", out)
                elif mm := re.fullmatch(r"act_(\d+)", name):
                    _snake(val, f"{r}.activations.{mm.group(1)}", out)
    return out


def _bert_from_jax(bert: dict, base: str, out: dict) -> None:
    """A JAX BertEncoder (or RobertaEncoder) tree -> HF keys under `base`."""
    e = f"{base}embeddings"
    out[f"{e}.word_embeddings.weight"] = _t(bert["word_embeddings"]["embedding"])
    out[f"{e}.position_embeddings.weight"] = _t(bert["position_embeddings"])
    out[f"{e}.token_type_embeddings.weight"] = _t(bert["token_type_embeddings"])
    _norm(bert["emb_norm"], f"{e}.LayerNorm", out)
    for key, lp in bert.items():
        if not (m := re.fullmatch(r"layer_(\d+)", key)):
            continue
        name = f"{base}encoder.layer.{m.group(1)}"
        sa = f"{name}.attention.self"
        if "qkv" in lp:
            _split_dense(lp["qkv"], [f"{sa}.query", f"{sa}.key", f"{sa}.value"], out)
        else:
            for jn, tn in (("q", "query"), ("k", "key"), ("v", "value")):
                _dense(lp[jn], f"{sa}.{tn}", out)
        _dense(lp["attn_out"], f"{name}.attention.output.dense", out)
        _norm(lp["attn_norm"], f"{name}.attention.output.LayerNorm", out)
        _dense(lp["ff_in"], f"{name}.intermediate.dense", out)
        _dense(lp["ff_out"], f"{name}.output.dense", out)
        _norm(lp["ff_norm"], f"{name}.output.LayerNorm", out)
    if "pooler" in bert:
        _dense(bert["pooler"], f"{base}pooler.dense", out)


def clap_text_from_jax(p: dict) -> SD:
    out: SD = {}
    _bert_from_jax(p["bert"], "base.", out)
    proj = p["projection"]
    _dense(proj["linear1"], "projection.linear1", out)
    _dense(proj["linear2"], "projection.linear2", out)
    _norm(proj["layer_norm"], "projection.layer_norm", out)
    return out


def t5_from_jax(p: dict) -> SD:
    out: SD = {"shared.weight": _t(p["token_embedder"]["embedding"]),
               "encoder.final_layer_norm.weight": _t(p["final_norm"]["weight"]),
               "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
                   _t(p["relative_attention_bias"])}
    for key, lp in p.items():
        if not (m := re.fullmatch(r"layer_(\d+)", key)):
            continue
        b = f"encoder.block.{m.group(1)}.layer"
        sa, ff = f"{b}.0.SelfAttention", f"{b}.1.DenseReluDense"
        if "qkv" in lp:
            _split_dense(lp["qkv"], [f"{sa}.{n}" for n in "qkv"], out)
        else:
            for n in "qkv":
                _dense(lp[n], f"{sa}.{n}", out)
        _dense(lp["o"], f"{sa}.o", out)
        if "wi" in lp:
            _split_dense(lp["wi"], [f"{ff}.wi_0", f"{ff}.wi_1"], out)
        else:
            _dense(lp["wi_0"], f"{ff}.wi_0", out)
            _dense(lp["wi_1"], f"{ff}.wi_1", out)
        _dense(lp["wo"], f"{ff}.wo", out)
        out[f"{b}.0.layer_norm.weight"] = _t(lp["attn_norm"]["weight"])
        out[f"{b}.1.layer_norm.weight"] = _t(lp["ff_norm"]["weight"])
    return out


def from_jax(params) -> dict:
    """JAX `PipelineParams` (numpy leaves; attributes or dict keys dit, vae,
    vocoder, clap_text, t5, scale_factor) -> the port's reference-layout state
    dicts {"dit", "vae", "vocoder", "clap_text", "t5": SD, "scale_factor": float}.
    Text towers are None when absent."""
    get = (lambda k: params[k]) if isinstance(params, dict) else (lambda k: getattr(params, k))
    return {
        "dit": dit_from_jax(get("dit")),
        "vae": vae_from_jax(get("vae")),
        "vocoder": vocoder_from_jax(get("vocoder")),
        "clap_text": None if get("clap_text") is None else clap_text_from_jax(get("clap_text")),
        "t5": None if get("t5") is None else t5_from_jax(get("t5")),
        "scale_factor": float(get("scale_factor")),
    }


# ---------------------------------------------------------------------------
# discriminators (JAX parameter trees -> the port's reference-layout state dicts)
# ---------------------------------------------------------------------------


def _conv_any(p: dict, name: str, out: dict) -> None:
    """Conv kernel (k..., in, out) -> Conv1d/Conv2d weight (out, in, k...)."""
    k = np.asarray(p["kernel"], np.float32)
    perm = (k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2))
    out[f"{name}.weight"] = _t(np.transpose(k, perm))
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def patchgan_from_jax(params: dict, batch_stats: Optional[dict] = None) -> SD:
    """NLayerDiscriminator2D / NLayerDiscriminator1dFeats / 1dSpecs: the JAX
    params (and BatchNorm batch_stats) -> `main.<i>` keys. In order of the
    forward: conv_0 (main.0), then each (conv_n or conv_tail_j, its norm)
    pair at main.2+3k / main.3+3k, then conv_out. BatchNorm: scale, bias,
    mean, var -> weight, bias, running_mean, running_var; ActNorm: loc and
    scale as (1, C, 1, 1), initialized."""
    out: SD = {}
    _conv_any(params["conv_0"], "main.0", out)
    mids = sorted((int(k[5:]), k) for k in params
                  if re.fullmatch(r"conv_\d+", k) and k != "conv_0")
    tails = sorted(k for k in params if k.startswith("conv_tail_"))
    pairs = [k for _, k in mids] + tails
    for i, conv in enumerate(pairs):
        _conv_any(params[conv], f"main.{2 + 3 * i}", out)
        suffix = conv[len("conv_"):]
        norm_name = next(n for n in (f"bn_{suffix}", f"norm_{suffix}") if n in params)
        norm, name = params[norm_name], f"main.{3 + 3 * i}"
        if "loc" in norm:
            out[f"{name}.loc"] = _t(norm["loc"]).reshape(1, -1, 1, 1)
            out[f"{name}.scale"] = _t(norm["scale"]).reshape(1, -1, 1, 1)
            out[f"{name}.initialized"] = torch.tensor(1, dtype=torch.uint8)
        else:
            _norm(norm, name, out)
            stats = batch_stats[norm_name]
            out[f"{name}.running_mean"] = _t(stats["mean"])
            out[f"{name}.running_var"] = _t(stats["var"])
            out[f"{name}.num_batches_tracked"] = torch.tensor(0)
    _conv_any(params["conv_out"], f"main.{2 + 3 * len(pairs)}", out)
    return out


def _subdisc(p: dict, name: str, out: dict) -> None:
    for key, sub in p.items():
        if m := re.fullmatch(r"conv_(\d+)", key):
            _conv_any(sub, f"{name}.convs.{m.group(1)}", out)
    _conv_any(p["conv_post"], f"{name}.conv_post", out)


def mpd_from_jax(params: dict, periods=(2, 3, 5, 7, 11)) -> SD:
    """MultiPeriodDiscriminator: p{period} -> discriminators.<i>."""
    out: SD = {}
    for i, period in enumerate(periods):
        _subdisc(params[f"p{period}"], f"discriminators.{i}", out)
    return out


def mrd_from_jax(params: dict, resolutions=((1024, 120, 600), (2048, 240, 1200),
                                            (512, 50, 240))) -> SD:
    """MultiResolutionDiscriminator: r{n_fft} -> discriminators.<i>."""
    out: SD = {}
    for i, res in enumerate(resolutions):
        _subdisc(params[f"r{res[0]}"], f"discriminators.{i}", out)
    return out


def _adv_rows(kernel: np.ndarray, hidden: int, freq_length: int, to_jax: bool) -> np.ndarray:
    """The multi-window head's input order: JAX flattens (T', F', C), the
    reference (C, T', F'); with reduction "none" T' is 1."""
    fp = (freq_length + 7) // 8
    tp = kernel.size // (fp * hidden)
    if to_jax:
        return kernel.reshape(hidden, tp, fp).transpose(1, 2, 0).reshape(-1, 1)
    return kernel.reshape(tp, fp, hidden).transpose(2, 0, 1).reshape(1, -1)


def multi_window_from_jax(params: dict, batch_stats: Optional[dict] = None,
                          time_lengths=(32, 64, 128), freq_length: int = 80) -> SD:
    """MultiWindowDiscriminatorWrapper: the JAX params and batch_stats ->
    `{discriminator,cond_disc}.conv_layers.<i>.model.<j>.{0,3}.*`,
    `.adv_layer.*` (rows permuted to the reference's flatten order) and
    `cond_disc.{mel,cond}_proj_layers.<i>.*`. "sn" convs: kernel ->
    weight_orig, flax's u and sigma -> weight_u, weight_sigma. A window
    JAX dropped at init (longer than its mel) has no entry."""
    out: SD = {}
    for tower, p in params.items():
        stats = (batch_stats or {}).get(tower, {})
        for i, win in enumerate(time_lengths):
            for proj in ("mel_proj", "cond_proj"):
                if f"{proj}_{i}" in p:
                    _dense(p[f"{proj}_{i}"], f"{tower}.{proj}_layers.{i}", out)
            if f"win_{win}" not in p:
                continue
            w, st, name = p[f"win_{win}"], stats.get(f"win_{win}", {}), f"{tower}.conv_layers.{i}"
            hidden = np.asarray(w["conv_0"]["kernel"]).shape[-1]
            for j in range(3):
                conv = f"{name}.model.{j}.0"
                _conv_any(w[f"conv_{j}"], conv, out)
                if f"SpectralNorm_{j}" in st:
                    sn = st[f"SpectralNorm_{j}"]
                    out[f"{conv}.weight_orig"] = out.pop(f"{conv}.weight")
                    out[f"{conv}.weight_u"] = _t(sn[f"conv_{j}/kernel/u"]).reshape(-1)
                    out[f"{conv}.weight_sigma"] = _t(sn[f"conv_{j}/kernel/sigma"]).reshape(())
                for norm in (f"bn_{j}", f"in_{j}"):
                    if norm in w:
                        _norm(w[norm], f"{name}.model.{j}.3", out)
                if f"bn_{j}" in st:
                    out[f"{name}.model.{j}.3.running_mean"] = _t(st[f"bn_{j}"]["mean"])
                    out[f"{name}.model.{j}.3.running_var"] = _t(st[f"bn_{j}"]["var"])
                    out[f"{name}.model.{j}.3.num_batches_tracked"] = torch.tensor(0)
            adv = w["adv_layer"]
            out[f"{name}.adv_layer.weight"] = _t(_adv_rows(
                np.asarray(adv["kernel"], np.float32), hidden, freq_length, to_jax=False))
            out[f"{name}.adv_layer.bias"] = _t(adv["bias"])
    return out


def multi_window_to_jax(sd: dict, time_lengths=(32, 64, 128), freq_length: int = 80) -> tuple:
    """The inverse of multi_window_from_jax: a reference-layout state dict
    -> (params, batch_stats) of JAX's MultiWindowDiscriminatorWrapper,
    every window of time_lengths present in `sd`."""
    a = lambda k: np.asarray(torch.as_tensor(sd[k]).detach().cpu().float().numpy())
    kernel2d = lambda w: w.transpose(2, 3, 1, 0)
    params: dict = {}
    stats: dict = {}
    for tower in ("discriminator", "cond_disc"):
        if not any(k.startswith(tower + ".") for k in sd):
            continue
        p, st = params.setdefault(tower, {}), {}
        for i, win in enumerate(time_lengths):
            for proj in ("mel_proj", "cond_proj"):
                key = f"{tower}.{proj}_layers.{i}"
                if f"{key}.weight" in sd:
                    p[f"{proj}_{i}"] = {"kernel": a(f"{key}.weight").T, "bias": a(f"{key}.bias")}
            name = f"{tower}.conv_layers.{i}"
            if f"{name}.adv_layer.weight" not in sd:
                continue
            w, wst = {}, {}
            for j in range(3):
                conv = f"{name}.model.{j}.0"
                if f"{conv}.weight_orig" in sd:
                    w[f"conv_{j}"] = {"kernel": kernel2d(a(f"{conv}.weight_orig")),
                                      "bias": a(f"{conv}.bias")}
                    wst[f"SpectralNorm_{j}"] = {
                        f"conv_{j}/kernel/u": a(f"{conv}.weight_u")[None, :],
                        f"conv_{j}/kernel/sigma": a(f"{conv}.weight_sigma").reshape(())}
                else:
                    w[f"conv_{j}"] = {"kernel": kernel2d(a(f"{conv}.weight")),
                                      "bias": a(f"{conv}.bias")}
                norm = f"{name}.model.{j}.3"
                if f"{norm}.running_mean" in sd:
                    w[f"bn_{j}"] = {"scale": a(f"{norm}.weight"), "bias": a(f"{norm}.bias")}
                    wst[f"bn_{j}"] = {"mean": a(f"{norm}.running_mean"),
                                      "var": a(f"{norm}.running_var")}
                elif f"{norm}.weight" in sd:
                    w[f"in_{j}"] = {"scale": a(f"{norm}.weight"), "bias": a(f"{norm}.bias")}
            hidden = w["conv_0"]["kernel"].shape[-1]
            w["adv_layer"] = {"kernel": _adv_rows(a(f"{name}.adv_layer.weight"), hidden,
                                                  freq_length, to_jax=True),
                              "bias": a(f"{name}.adv_layer.bias")}
            p[f"win_{win}"] = w
            if wst:
                st[f"win_{win}"] = wst
        if st:
            stats[tower] = st
    return params, stats


# ---------------------------------------------------------------------------
# LAION open_clap (JAX variables -> the reference CLAP layout)
# ---------------------------------------------------------------------------


def _bn_from_jax(p: dict, stats: dict, name: str, out: dict) -> None:
    """flax BatchNorm scale, bias, mean, var -> weight, bias, running_mean,
    running_var (and num_batches_tracked 0)."""
    _norm(p, name, out)
    out[f"{name}.running_mean"] = _t(stats["mean"])
    out[f"{name}.running_var"] = _t(stats["var"])
    out[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _fusion_from_jax(p: dict, stats: dict, name: str, out: dict) -> None:
    """AFF / iAFF: each bottleneck's conv1, bn1, conv2, bn2 -> the
    Sequential's 0, 1, 3, 4 (the global ones' pool at 0 shifts them by one).
    iAFF's never-called global_att2, which JAX drops, gets its init."""
    for branch, sub in p.items():
        off = 1 if branch.startswith("global") else 0
        b = f"{name}.{branch}"
        _conv_any(sub["conv1"], f"{b}.{off}", out)
        _bn_from_jax(sub["bn1"], stats[branch]["bn1"], f"{b}.{1 + off}", out)
        _conv_any(sub["conv2"], f"{b}.{3 + off}", out)
        _bn_from_jax(sub["bn2"], stats[branch]["bn2"], f"{b}.{4 + off}", out)
    if "local_att2" in p:
        from audiolcm_torch.models.open_clap.fusion import iAFF

        kernel = np.asarray(p["local_att"]["conv2"]["kernel"])
        module = iAFF(kernel.shape[-1], type="2D" if kernel.ndim == 4 else "1D")
        for k, v in module.global_att2.state_dict().items():
            out[f"{name}.global_att2.{k}"] = v


def _mel_conv1d_from_jax(p: dict, st: dict, out: dict) -> None:
    """The 1D fusion's mel conv and its BatchNorm (HTSAT and PANN)."""
    _conv_any(p["mel_conv1d"], "audio_branch.mel_conv1d.0", out)
    _bn_from_jax(p["mel_conv1d_bn"], st["mel_conv1d_bn"], "audio_branch.mel_conv1d.1", out)


def _htsat_from_jax(p: dict, st: dict, out: dict) -> None:
    a = "audio_branch"
    _bn_from_jax(p["bn0"], st["bn0"], f"{a}.bn0", out)
    _conv_any(p["proj"], f"{a}.patch_embed.proj", out)
    _norm(p["patch_norm"], f"{a}.patch_embed.norm", out)
    for key, sub in p.items():
        if m := re.fullmatch(r"layer_(\d+)_block_(\d+)", key):
            b = f"{a}.layers.{m.group(1)}.blocks.{m.group(2)}"
            _norm(sub["norm1"], f"{b}.norm1", out)
            _norm(sub["norm2"], f"{b}.norm2", out)
            _dense(sub["fc1"], f"{b}.mlp.fc1", out)
            _dense(sub["fc2"], f"{b}.mlp.fc2", out)
            _dense(sub["attn"]["qkv"], f"{b}.attn.qkv", out)
            _dense(sub["attn"]["proj"], f"{b}.attn.proj", out)
            out[f"{b}.attn.relative_position_bias_table"] = _t(
                sub["attn"]["relative_position_bias_table"])
        elif m := re.fullmatch(r"downsample_(\d+)", key):
            d = f"{a}.layers.{m.group(1)}.downsample"
            _norm(sub["norm"], f"{d}.norm", out)
            _dense(sub["reduction"], f"{d}.reduction", out)
    _norm(p["norm"], f"{a}.norm", out)
    _conv_any(p["tscam_conv"], f"{a}.tscam_conv", out)
    if "mel_conv2d" in p:  # the 2D fusion lives in patch_embed
        _conv_any(p["mel_conv2d"], f"{a}.patch_embed.mel_conv2d", out)
        if "fusion_model" in p:
            _fusion_from_jax(p["fusion_model"], st["fusion_model"],
                             f"{a}.patch_embed.fusion_model", out)
    if "mel_conv1d" in p:
        _mel_conv1d_from_jax(p, st, out)
        if "fusion_model" in p:
            _fusion_from_jax(p["fusion_model"], st["fusion_model"], f"{a}.fusion_model", out)


def _pann_from_jax(p: dict, st: dict, out: dict) -> None:
    a = "audio_branch"
    _bn_from_jax(p["bn0"], st["bn0"], f"{a}.bn0", out)
    for key, sub in p.items():
        if re.fullmatch(r"conv_block\d+", key):
            for name, leaf in sub.items():
                if name.startswith("conv"):
                    _conv_any(leaf, f"{a}.{key}.{name}", out)
                else:
                    _bn_from_jax(leaf, st[key][name], f"{a}.{key}.{name}", out)
    _dense(p["fc1"], f"{a}.fc1", out)
    _dense(p["fc_audioset"], f"{a}.fc_audioset", out)
    if "mel_conv1d" in p:
        _mel_conv1d_from_jax(p, st, out)
    if "mel_conv2d" in p:
        _conv_any(p["mel_conv2d"], f"{a}.mel_conv2d.0", out)
        _bn_from_jax(p["mel_conv2d_bn"], st["mel_conv2d_bn"], f"{a}.mel_conv2d.1", out)
    if "fusion_model" in p:
        _fusion_from_jax(p["fusion_model"], st["fusion_model"], f"{a}.fusion_model", out)


def _bart_from_jax(p: dict, out: dict) -> None:
    e = "text_branch.encoder"
    out[f"{e}.embed_tokens.weight"] = _t(p["embed_tokens"]["embedding"])
    out[f"{e}.embed_positions.weight"] = _t(p["embed_positions"])
    _norm(p["layernorm_embedding"], f"{e}.layernorm_embedding", out)
    n = sum(1 for k in p if re.fullmatch(r"q_\d+", k))
    for i in range(n):
        layer, sa = f"{e}.layers.{i}", f"{e}.layers.{i}.self_attn"
        for jn, tn in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                       ("attn_out", "out_proj")):
            _dense(p[f"{jn}_{i}"], f"{sa}.{tn}", out)
        for jn in ("self_attn_layer_norm", "final_layer_norm"):
            _norm(p[f"{jn}_{i}"], f"{layer}.{jn}", out)
        _dense(p[f"fc1_{i}"], f"{layer}.fc1", out)
        _dense(p[f"fc2_{i}"], f"{layer}.fc2", out)


def _clip_text_from_jax(p: dict, out: dict) -> None:
    t = "text_branch"
    out[f"{t}.token_embedding.weight"] = _t(p["token_embedding"]["embedding"])
    out[f"{t}.positional_embedding"] = _t(p["positional_embedding"])
    _norm(p["ln_final"], f"{t}.ln_final", out)
    n = sum(1 for k in p if re.fullmatch(r"ln_1_\d+", k))
    for i in range(n):
        b = f"{t}.resblocks.{i}"
        _norm(p[f"ln_1_{i}"], f"{b}.ln_1", out)
        _norm(p[f"ln_2_{i}"], f"{b}.ln_2", out)
        out[f"{b}.attn.in_proj_weight"] = _t(p[f"attn_in_{i}"]["kernel"]).T.contiguous()
        out[f"{b}.attn.in_proj_bias"] = _t(p[f"attn_in_{i}"]["bias"])
        _dense(p[f"attn_out_{i}"], f"{b}.attn.out_proj", out)
        _dense(p[f"mlp_fc_{i}"], f"{b}.mlp.c_fc", out)
        _dense(p[f"mlp_proj_{i}"], f"{b}.mlp.c_proj", out)


def open_clap_from_jax(variables: dict, cfg) -> SD:
    """JAX OpenClap variables {"params", "batch_stats"} (numpy leaves) -> the
    reference CLAP state dict the port's `models/open_clap.OpenClap` loads:
    the inverse of `audiolcm_tpu/models/open_clap/convert.py:convert_open_clap`
    for every text branch of `cfg` (the port's OpenClapConfig) and the HTSAT
    or PANN tower, BatchNorm running statistics included. Subtrees absent
    from `variables` (the audio side of a text-only init) are left out."""
    from audiolcm_torch.models.open_clap.htsat import HTSATConfig

    p, st = variables["params"], variables.get("batch_stats", {})
    out: SD = {k: _t(p[k]) for k in ("logit_scale_a", "logit_scale_t") if k in p}
    for name in ("text_projection", "audio_projection"):
        if name in p:
            _dense(p[name]["linear1"], f"{name}.0", out)
            _dense(p[name]["linear2"], f"{name}.2", out)
    for name in ("text_transform", "audio_transform"):
        if name in p:
            _dense(p[name]["linear_0"], f"{name}.sequential.0", out)
            _dense(p[name]["linear_1"], f"{name}.sequential.3", out)
    text = p["text_branch"]
    kind = cfg.text_model_type
    if kind in ("roberta", "bert"):
        _bert_from_jax(text, "text_branch.", out)
    elif kind == "bart":
        _bart_from_jax(text, out)
    else:
        _clip_text_from_jax(text, out)
    if "audio_branch" in p:
        audio = _htsat_from_jax if isinstance(cfg.audio, HTSATConfig) else _pann_from_jax
        audio(p["audio_branch"], st.get("audio_branch", {}), out)
    return out
