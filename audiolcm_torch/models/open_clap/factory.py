"""The open_clap model factory: named configs -> an OpenClap module, with a
reference checkpoint loaded into it (`audiolcm_tpu/models/open_clap/factory.py`).

Reference `ldm/modules/encoders/open_clap/factory.py:68-257`
(`create_model(amodel_name, tmodel_name, pretrained, ..., enable_fusion,
fusion_type)`): the audio model's config by name, the text branch named by
tmodel_name, and the checkpoint's `state_dict` (a DDP `module.` prefix
stripped) loaded directly, since the port keeps the reference's keys. The
table re-types the reference's `model_configs/*.json` audio entries; every
one shares text_cfg {context_length 77, vocab 49408, width 512, heads 8,
layers 12} except PANN-14-tiny-transformer (layers 4).
"""

from __future__ import annotations

import re
from typing import Tuple

from audiolcm_torch.models.open_clap.htsat import htsat_preset
from audiolcm_torch.models.open_clap.model import OpenClap, OpenClapConfig
from audiolcm_torch.models.open_clap.pann import PannConfig

# name -> (embed_dim, audio kwargs); defaults: 48 kHz, win 1024, hop 480,
# 64 mel, fmin 50, fmax 14000, 527 classes
MODEL_CONFIGS = {
    "HTSAT-tiny": (768, dict(kind="HTSAT", model_name="tiny")),
    "HTSAT-base": (1024, dict(kind="HTSAT", model_name="base")),
    "HTSAT-large": (2048, dict(kind="HTSAT", model_name="large")),
    "HTSAT-tiny-win-1536": (768, dict(kind="HTSAT", model_name="tiny", window_size_stft=1536)),
    "PANN-14": (2048, dict(kind="PANN", model_name="Cnn14")),
    "PANN-10": (1024, dict(kind="PANN", model_name="Cnn10")),
    "PANN-6": (512, dict(kind="PANN", model_name="Cnn6")),
    "PANN-14-fmax-18k": (2048, dict(kind="PANN", model_name="Cnn14", fmax=18000.0)),
    "PANN-14-fmax-8k-20s": (2048, dict(kind="PANN", model_name="Cnn14", fmax=8000.0,
                                       hop_size=360)),
    "PANN-14-win-1536": (2048, dict(kind="PANN", model_name="Cnn14", window_size=1536)),
    "PANN-14-tiny-transformer": (2048, dict(kind="PANN", model_name="Cnn14", text_layers=4)),
}

# Reference checkpoint entries the port does not hold: buffers it computes
# from the shapes (torchlibrosa's STFT and mel bases, the Swin relative
# position index and shift masks, HF's position / token-type ids) and
# HTSAT's `head`, which its forward never calls.
_DERIVED = re.compile(r"^audio_branch\.(spectrogram_extractor|logmel_extractor|head)\."
                      r"|\.relative_position_index$|\.attn_mask$"
                      r"|^text_branch\.embeddings\.(position_ids|token_type_ids)$")
# ... and what a branch's HF model has beyond the tower the JAX package
# builds: BERT's pooler (CLS stands in), BART's decoder and shared table.
_UNUSED_TEXT = {"bert": re.compile(r"^text_branch\.pooler\."),
                "bart": re.compile(r"^text_branch\.(decoder|shared)\.")}


def list_models():
    return sorted(MODEL_CONFIGS)


def build_config(amodel_name: str, tmodel_name: str, enable_fusion: bool = False,
                 fusion_type: str = "None") -> OpenClapConfig:
    amodel_name = amodel_name.replace("/", "-")
    if amodel_name not in MODEL_CONFIGS:
        raise RuntimeError(f"Model config for {amodel_name} not found; "
                           f"available models {list_models()}.")
    embed_dim, spec = MODEL_CONFIGS[amodel_name]
    spec = dict(spec)
    kind = spec.pop("kind")
    text_layers = spec.pop("text_layers", 12)
    if kind == "HTSAT":
        audio = htsat_preset(spec.pop("model_name"), enable_fusion=enable_fusion,
                             fusion_type=fusion_type, **spec)
    else:
        audio = PannConfig(enable_fusion=enable_fusion, fusion_type=fusion_type, **spec)
    return OpenClapConfig(embed_dim=embed_dim, audio=audio, text_model_type=tmodel_name,
                          text_layers=text_layers)


def load_checkpoint(model: OpenClap, path: str) -> OpenClap:
    """A reference CLAP checkpoint into `model`, strictly: the `module.`
    prefix stripped and the entries the port derives or does not build
    dropped. The JAX package converts the roberta, bert and bart branches
    and the HTSAT and PANN towers; a `transformer` text branch has no
    conversion there and raises here."""
    from audiolcm_torch.convert import load_state_dict

    kind = model.config.text_model_type
    if kind == "transformer":
        raise ValueError("a 'transformer' text-branch CLAP checkpoint has no conversion (the JAX "
                         "package converts the roberta, bert and bart branches only)")
    sd = load_state_dict(path)
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    unused = _UNUSED_TEXT.get(kind)
    sd = {k: v for k, v in sd.items()
          if not _DERIVED.search(k) and not (unused is not None and unused.search(k))}
    model.load_state_dict(sd, strict=True)
    return model


def create_model(amodel_name: str, tmodel_name: str, pretrained: str = "",
                 enable_fusion: bool = False,
                 fusion_type: str = "None") -> Tuple[OpenClap, OpenClapConfig]:
    """(module on the CPU, config); with a `pretrained` checkpoint path its
    weights are loaded (`load_checkpoint`), else the module's init."""
    cfg = build_config(amodel_name, tmodel_name, enable_fusion, fusion_type)
    model = OpenClap(cfg)
    if pretrained:
        load_checkpoint(model, pretrained)
    return model, cfg
