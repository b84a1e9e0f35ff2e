"""Checkpoint loading for the port, and weights carried over from the JAX
package.

The port's modules keep the reference PyTorch state-dict layout, so a
reference checkpoint loads with `load_state_dict` + `assign_state_dict`
(after `fold_weight_norms` for the vocoder). `from_jax` turns the JAX
package's parameter trees (numpy leaves) back into that layout:

  Dense kernel (in, out)           -> Linear weight (out, in)
  Conv kernel (k, in, out)         -> Conv1d weight (out, in, k)
  ConvTranspose1dTorchParity       -> ConvTranspose1d weight (in, out, k)
    kernel (k, in, out), k flipped    (time flip undone)
  GroupNorm/LayerNorm scale        -> weight
  snake alpha/beta                 -> as stored (log scale)
  fused Q/K/V, T5 gated-FF pairs   -> split back into the separate tensors
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
    out[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"], np.float32), (2, 1, 0))).contiguous()
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
    out: SD = {}
    te = p["t_embedder"]
    _dense(te["mlp_0"], "t_embedder.mlp.0", out)
    _dense(te["mlp_2"], "t_embedder.mlp.2", out)
    _dense(te["proj_w"], "t_embedder.proj_w", out)
    for c in ("c1_embedder", "c2_embedder"):
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
    """Both halves of the VAE with their quant convs."""
    out: SD = {}
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


def clap_text_from_jax(p: dict) -> SD:
    out: SD = {}
    bert, e = p["bert"], "base.embeddings"
    out[f"{e}.word_embeddings.weight"] = _t(bert["word_embeddings"]["embedding"])
    out[f"{e}.position_embeddings.weight"] = _t(bert["position_embeddings"])
    out[f"{e}.token_type_embeddings.weight"] = _t(bert["token_type_embeddings"])
    _norm(bert["emb_norm"], f"{e}.LayerNorm", out)
    for key, lp in bert.items():
        if not (m := re.fullmatch(r"layer_(\d+)", key)):
            continue
        name = f"base.encoder.layer.{m.group(1)}"
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
