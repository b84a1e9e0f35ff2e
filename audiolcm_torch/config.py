"""The reference YAML schema -> the port's modules (`audiolcm_tpu/config.py`).

An explicit registry of the reference's target strings in place of its
reflection (`instantiate_from_config`, ldm/util.py:111-126): the
denoisers ConcatDiT2MLP, ConcatDiT, ConcatOrderDiT(2) and TxtFlagLargeDiT,
the 1D and the 2D AutoencoderKL, and the text conditioners
FrozenCLAPFLANEmbedder, FrozenT5Embedder, FrozenFLANEmbedder,
FrozenCLAPEmbedder and the two LAION CLAP conditioners
(FrozenLAIONCLAPEmbedder, FrozenLAIONCLAPSetenceEmbedder); BigVGAN from a
vocoder args.yml. `build_from_target` builds a node's modules;
`parse_diffusion_config` reads an LDM's `model.params` into constructor
arguments. Modules are built on the CPU in float32; the caller moves them.
`load_yaml` imports PyYAML only when called.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict

from audiolcm_torch.models.bigvgan import BigVGAN, BigVGANConfig
from audiolcm_torch.models.clap_text import BertConfig, ClapTextEncoder
from audiolcm_torch.models.dit import ConcatDiT, ConcatDiT2MLP
from audiolcm_torch.models.flag_dit import TxtFlagLargeDiT
from audiolcm_torch.models.order_dit import ConcatOrderDiT, ConcatOrderDiT2
from audiolcm_torch.models.t5_encoder import T5Config, T5Encoder
from audiolcm_torch.models.vae1d import AutoencoderKL1D, VAEConfig
from audiolcm_torch.models.vae2d import AutoencoderKL2D, VAE2DConfig


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


# the serving knobs a denoiser's constructor may take
SERVING_KNOBS = ("use_flash", "fuse_qkv")


@dataclasses.dataclass(frozen=True)
class DiTSpec:
    """A denoiser's class and its constructor arguments."""

    cls: type
    kwargs: dict

    def build(self, **knobs):
        """The denoiser with the serving knobs (`SERVING_KNOBS`) its
        constructor takes. A knob it does not take is dropped when off (False
        or None) and refused with a TypeError when on, as is a name that is
        no serving knob."""
        unknown = sorted(set(knobs) - set(SERVING_KNOBS))
        if unknown:
            raise TypeError(f"{unknown} are not serving knobs (known: {sorted(SERVING_KNOBS)})")
        params = inspect.signature(self.cls).parameters
        takes = {k: v for k, v in knobs.items() if k in params}
        refused = sorted(k for k, v in knobs.items() if k not in takes and v)
        if refused:
            taken = sorted(k for k in SERVING_KNOBS if k in params)
            raise TypeError(f"{self.cls.__name__} does not take the serving knob(s) {refused}; "
                            f"it takes {taken or 'none'}")
        return self.cls(**self.kwargs, **takes)


def _dit(cls: type) -> Callable[[dict], DiTSpec]:
    """The kwargs the JAX registry reads for `cls` (`audiolcm_tpu/config.py:
    30-43,104-134`): out_channels for ConcatDiT2MLP only, the grouped-KV,
    FF-width and qk-norm knobs for TxtFlagLargeDiT only; for the latter also
    the reference's `ffn_dim_multiplier` and `norm_eps`, which the JAX
    registry drops."""

    def parse(p: dict) -> DiTSpec:
        kw = dict(in_channels=p["in_channels"], context_dim=p["context_dim"],
                  hidden_size=p.get("hidden_size", 576), depth=p.get("depth", 4),
                  num_heads=p.get("num_heads", 8), max_len=p.get("max_len", 1000))
        if cls is ConcatDiT2MLP:
            kw["out_channels"] = p.get("out_channels")
        elif cls is TxtFlagLargeDiT:
            kw.update(n_kv_heads=p.get("n_kv_heads"), multiple_of=p.get("multiple_of", 256),
                      ffn_dim_multiplier=p.get("ffn_dim_multiplier"),
                      norm_eps=p.get("norm_eps", 1e-5), qk_norm=bool(p.get("qk_norm") or False))
        return DiTSpec(cls, kw)

    return parse


def _vae_config(p: dict) -> VAEConfig:
    dd = p["ddconfig"]
    return VAEConfig(
        in_channels=dd["in_channels"], out_ch=dd["out_ch"], ch=dd["ch"],
        ch_mult=tuple(dd["ch_mult"]), num_res_blocks=dd["num_res_blocks"],
        attn_layers=tuple(dd.get("attn_layers", ())), down_layers=tuple(dd.get("down_layers", ())),
        kernel_size=dd.get("kernel_size", 3), z_channels=dd["z_channels"],
        embed_dim=p["embed_dim"], double_z=dd.get("double_z", True),
        dropout=dd.get("dropout", 0.0))


def _vae2d_config(p: dict) -> VAE2DConfig:
    dd = p["ddconfig"]
    return VAE2DConfig(
        in_channels=dd["in_channels"], out_ch=dd["out_ch"], ch=dd["ch"],
        ch_mult=tuple(dd["ch_mult"]), num_res_blocks=dd["num_res_blocks"],
        attn_resolutions=tuple(dd.get("attn_resolutions", ())),
        resolution=dd.get("resolution", 80), z_channels=dd["z_channels"],
        embed_dim=p["embed_dim"], double_z=dd.get("double_z", True),
        dropout=dd.get("dropout", 0.0))


def _clapflan(p: dict) -> dict:
    """Tower configs; `bert_config`/`t5_config`/`d_proj` are the JAX
    package's extensions for scaled-down towers."""
    return {"bert": BertConfig(**(p.get("bert_config") or {})),
            "t5": T5Config(**(p.get("t5_config") or {})),
            "d_proj": p.get("d_proj", 1024), "max_length": p.get("max_length", 77)}


def _t5_only(p: dict) -> dict:
    """FrozenT5Embedder / FrozenFLANEmbedder (`encoders/modules.py:143,172`):
    one T5 tower, no CLAP half."""
    return {"bert": None, "t5": T5Config(**(p.get("t5_config") or {})), "d_proj": None,
            "max_length": p.get("max_length", 77), "single_tower": True}


def _clap_only(p: dict) -> dict:
    """FrozenCLAPEmbedder (`encoders/modules.py:201`): the CLAP tower alone."""
    return {"bert": BertConfig(**(p.get("bert_config") or {})), "t5": None,
            "d_proj": p.get("d_proj", 1024), "max_length": p.get("max_length", 77),
            "single_tower": True}


@dataclasses.dataclass(frozen=True)
class LaionSpec:
    """A LAION CLAP conditioner's constructor arguments: the params the JAX
    registry reads (`audiolcm_tpu/config.py:102-117`); the sentence class
    takes weights_path and tokenizer_path only."""

    sentence_cls: bool
    kwargs: dict

    def build(self):
        """The embedder, on the CPU."""
        from audiolcm_torch.models.open_clap.embedders import (FrozenLAIONCLAPEmbedder,
                                                              FrozenLAIONCLAPSetenceEmbedder)

        if self.sentence_cls:
            return FrozenLAIONCLAPSetenceEmbedder(**self.kwargs, device="cpu")
        return FrozenLAIONCLAPEmbedder(**self.kwargs, device="cpu")


def _laion(sentence_cls: bool) -> Callable[[dict], LaionSpec]:
    def parse(p: dict) -> LaionSpec:
        kw = dict(weights_path=p.get("weights_path", ""),
                  tokenizer_path=p.get("tokenizer_path", "roberta-base"))
        if not sentence_cls:
            kw.update(sentence=bool(p.get("sentence", False)),
                      max_length=p.get("max_length", 77))
        return LaionSpec(sentence_cls, kw)

    return parse


_DIT = "ldm.modules.diffusionmodules."
_ENC = "ldm.modules.encoders.modules."
REGISTRY: Dict[str, Callable[[dict], Any]] = {
    _DIT + "concatDiT.ConcatDiT2MLP": _dit(ConcatDiT2MLP),
    _DIT + "concatDiT.ConcatDiT": _dit(ConcatDiT),
    _DIT + "concatDiT.ConcatOrderDiT": _dit(ConcatOrderDiT),
    _DIT + "concatDiT.ConcatOrderDiT2": _dit(ConcatOrderDiT2),
    _DIT + "flag_large_dit.TxtFlagLargeDiT": _dit(TxtFlagLargeDiT),
    "ldm.models.autoencoder1d.AutoencoderKL": _vae_config,
    "ldm.models.autoencoder.AutoencoderKL": _vae2d_config,
    _ENC + "FrozenCLAPFLANEmbedder": _clapflan,
    _ENC + "FrozenT5Embedder": _t5_only,
    _ENC + "FrozenFLANEmbedder": _t5_only,
    _ENC + "FrozenCLAPEmbedder": _clap_only,
    _ENC + "FrozenLAIONCLAPEmbedder": _laion(False),
    _ENC + "FrozenLAIONCLAPSetenceEmbedder": _laion(True),
}


def _vae_cls(cfg) -> type:
    return AutoencoderKL2D if isinstance(cfg, VAE2DConfig) else AutoencoderKL1D


def _towers(cond: dict) -> dict:
    """The text conditioner's modules in the JAX registry's dict shape:
    {"clap_text", "t5", "max_length"} (+ "single_tower": True, the absent
    tower None)."""
    out = {"clap_text": None if cond["bert"] is None else ClapTextEncoder(cond["bert"],
                                                                         cond["d_proj"]),
           "t5": None if cond["t5"] is None else T5Encoder(cond["t5"]),
           "max_length": cond["max_length"]}
    if cond.get("single_tower"):
        out["single_tower"] = True
    return out


def build_from_target(node: dict):
    """A `{target, params}` node's modules: a denoiser, a VAE, the text
    towers (`_towers`) or a LAION CLAP embedder."""
    parsed = _parse(node)
    if isinstance(parsed, (DiTSpec, LaionSpec)):
        return parsed.build()
    if isinstance(parsed, (VAEConfig, VAE2DConfig)):
        return _vae_cls(parsed)(parsed)
    return _towers(parsed)


def _parse(node: dict):
    target = node["target"]
    if target not in REGISTRY:
        raise KeyError(f"config target {target!r} is not ported; known: {sorted(REGISTRY)}")
    return REGISTRY[target](node.get("params") or {})


def build_vae(node: dict):
    """The VAE of one `{target, params}` node: a root model of
    configs/autoencoder1d.yaml or an LDM's first_stage_config (1D or 2D)."""
    cfg = _parse(node)
    if not isinstance(cfg, (VAEConfig, VAE2DConfig)):
        raise ValueError(f"config target {node['target']!r} is not a VAE")
    return _vae_cls(cfg)(cfg)


@dataclasses.dataclass
class DiffusionSystemConfig:
    """Parsed `model.params`: constructor arguments, not modules, so the
    caller picks knobs (fuse flags) before building."""

    dit: DiTSpec
    vae: Any  # VAEConfig or VAE2DConfig
    cond: Any  # the towers' configs (dict) or a LaionSpec
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.012
    mel_length: int = 312
    num_ddim_timesteps: int = 50
    w_min: float = 4.0
    w_max: float = 12.0
    scale_by_std: bool = False
    base_learning_rate: float = 3.0e-6

    def build_dit(self, **knobs):
        """The class the unet_config names, with the serving knobs
        (use_flash, fuse_qkv) it takes (`DiTSpec.build`)."""
        return self.dit.build(**knobs)

    def build_vae(self):
        return _vae_cls(self.vae)(self.vae)

    def build_clap_text(self, fuse_proj: bool = False) -> ClapTextEncoder:
        return ClapTextEncoder(self._tower("bert"), self.cond["d_proj"], fuse_proj)

    def build_t5(self, fuse_proj: bool = False) -> T5Encoder:
        return T5Encoder(self._tower("t5"), fuse_proj)

    def _tower(self, name: str):
        if isinstance(self.cond, LaionSpec):
            raise ValueError(f"the cond_stage_config is a LAION CLAP conditioner, which has no "
                             f"{name} tower (build it with cond.build())")
        if self.cond[name] is None:
            raise ValueError(f"the cond_stage_config is a single-tower conditioner without "
                             f"the {name} tower")
        return self.cond[name]


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
