"""The reference YAML schema -> the port's modules (`audiolcm_tpu/config.py`).

Covers what the three shipped YAMLs (configs/audiolcm.yaml, teacher.yaml,
autoencoder1d.yaml) and a vocoder args.yml need: the three targets they
name (ConcatDiT2MLP, the 1D AutoencoderKL, FrozenCLAPFLANEmbedder) through
an explicit registry in place of the reference's reflection
(`instantiate_from_config`, ldm/util.py:111-126), and BigVGAN from args.
`build_from_target` builds a node's modules; `parse_diffusion_config`
reads an LDM's `model.params` into constructor arguments. Modules are
built on the CPU in float32; the caller moves them. `load_yaml` imports
PyYAML only when called.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

from audiolcm_torch.models.bigvgan import BigVGAN, BigVGANConfig
from audiolcm_torch.models.clap_text import BertConfig, ClapTextEncoder
from audiolcm_torch.models.dit import ConcatDiT2MLP
from audiolcm_torch.models.t5_encoder import T5Config, T5Encoder
from audiolcm_torch.models.vae1d import AutoencoderKL1D, VAEConfig


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _dit_kwargs(p: dict) -> dict:
    return dict(in_channels=p["in_channels"], context_dim=p["context_dim"],
                hidden_size=p.get("hidden_size", 576), depth=p.get("depth", 4),
                num_heads=p.get("num_heads", 8), max_len=p.get("max_len", 1000),
                out_channels=p.get("out_channels"))


def _vae_config(p: dict) -> VAEConfig:
    dd = p["ddconfig"]
    return VAEConfig(
        in_channels=dd["in_channels"], out_ch=dd["out_ch"], ch=dd["ch"],
        ch_mult=tuple(dd["ch_mult"]), num_res_blocks=dd["num_res_blocks"],
        attn_layers=tuple(dd.get("attn_layers", ())), down_layers=tuple(dd.get("down_layers", ())),
        kernel_size=dd.get("kernel_size", 3), z_channels=dd["z_channels"],
        embed_dim=p["embed_dim"], double_z=dd.get("double_z", True),
        dropout=dd.get("dropout", 0.0))


def _clapflan(p: dict) -> dict:
    """Tower configs; `bert_config`/`t5_config`/`d_proj` are the JAX
    package's extensions for scaled-down towers."""
    return {"bert": BertConfig(**(p.get("bert_config") or {})),
            "t5": T5Config(**(p.get("t5_config") or {})),
            "d_proj": p.get("d_proj", 1024), "max_length": p.get("max_length", 77)}


REGISTRY: Dict[str, Callable[[dict], Any]] = {
    "ldm.modules.diffusionmodules.concatDiT.ConcatDiT2MLP": _dit_kwargs,
    "ldm.models.autoencoder1d.AutoencoderKL": _vae_config,
    "ldm.modules.encoders.modules.FrozenCLAPFLANEmbedder": _clapflan,
}


def build_from_target(node: dict):
    """A `{target, params}` node's modules: the DiT, the VAE, or the text
    towers as {"clap_text", "t5", "max_length"}."""
    parsed = _parse(node)
    if isinstance(parsed, VAEConfig):
        return AutoencoderKL1D(parsed)
    if "bert" in parsed:
        return {"clap_text": ClapTextEncoder(parsed["bert"], parsed["d_proj"]),
                "t5": T5Encoder(parsed["t5"]), "max_length": parsed["max_length"]}
    return ConcatDiT2MLP(**parsed)


def _parse(node: dict):
    target = node["target"]
    if target not in REGISTRY:
        raise KeyError(f"config target {target!r} is not ported; known: {sorted(REGISTRY)}")
    return REGISTRY[target](node.get("params") or {})


def build_vae(node: dict) -> AutoencoderKL1D:
    """The VAE of one `{target, params}` node: a root model of
    configs/autoencoder1d.yaml or an LDM's first_stage_config."""
    cfg = _parse(node)
    if not isinstance(cfg, VAEConfig):
        raise ValueError(f"config target {node['target']!r} is not a VAE")
    return AutoencoderKL1D(cfg)


@dataclasses.dataclass
class DiffusionSystemConfig:
    """Parsed `model.params`: constructor arguments, not modules, so the
    caller picks knobs (fuse flags) before building."""

    dit: dict
    vae: VAEConfig
    cond: dict
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.012
    mel_length: int = 312
    num_ddim_timesteps: int = 50
    w_min: float = 4.0
    w_max: float = 12.0
    scale_by_std: bool = False
    base_learning_rate: float = 3.0e-6

    def build_dit(self, **knobs) -> ConcatDiT2MLP:
        return ConcatDiT2MLP(**self.dit, **knobs)

    def build_vae(self) -> AutoencoderKL1D:
        return AutoencoderKL1D(self.vae)

    def build_clap_text(self, fuse_proj: bool = False) -> ClapTextEncoder:
        return ClapTextEncoder(self.cond["bert"], self.cond["d_proj"], fuse_proj)

    def build_t5(self, fuse_proj: bool = False) -> T5Encoder:
        return T5Encoder(self.cond["t5"], fuse_proj)


def parse_diffusion_config(cfg: dict) -> DiffusionSystemConfig:
    """cfg = the full YAML dict (configs/audiolcm.yaml schema)."""
    p = cfg["model"]["params"]
    return DiffusionSystemConfig(
        dit=_parse(p["unet_config"]), vae=_parse(p["first_stage_config"]),
        cond=_parse(p["cond_stage_config"]), timesteps=p.get("timesteps", 1000),
        linear_start=p.get("linear_start", 0.00085), linear_end=p.get("linear_end", 0.012),
        mel_length=p.get("mel_length", 312),
        num_ddim_timesteps=p.get("num_ddim_timesteps", 50), w_min=p.get("w_min", 4.0),
        w_max=p.get("w_max", 12.0), scale_by_std=p.get("scale_by_std", False),
        base_learning_rate=cfg["model"].get("base_learning_rate", 3.0e-6))


def vocoder_config_from_args(args: dict) -> BigVGANConfig:
    """BigVGANConfig from a vocoder args.yml dict."""
    return BigVGANConfig(
        num_mels=args.get("num_mels", 80),
        upsample_rates=tuple(args["upsample_rates"]),
        upsample_kernel_sizes=tuple(args["upsample_kernel_sizes"]),
        upsample_initial_channel=args["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(args["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in args["resblock_dilation_sizes"]),
        activation=args.get("activation", "snakebeta"),
        snake_logscale=bool(args.get("snake_logscale", True)),
        resblock=str(args.get("resblock", "1")))


def build_vocoder_from_args(args: dict, **knobs) -> BigVGAN:
    return BigVGAN(vocoder_config_from_args(args), **knobs)
