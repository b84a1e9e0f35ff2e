"""The port's native pipeline checkpoint (`audiolcm_tpu/convert/native_ckpt.py`).

A reference checkpoint is the migration path (`api.build_pipeline`); once a
pipeline is built, it saves and loads natively, so serving never reads the
reference files again. A directory holds

  modules.pt     torch.save of each module's state dict as the pipeline
                 holds it: the DiT's QKV fused when `fuse_qkv`, the text
                 towers' projections fused when `fuse_proj`, the vocoder's
                 weight norm folded into `weight`, every tensor in the
                 compute dtype;
  pipeline.json  the JAX sidecar's keys (`default_latent_len`, the three
                 `lcm` fields, `num_timesteps`), plus `scale_factor` (which
                 the JAX package keeps in its parameter tree), the compute
                 dtype, and the knobs that shaped the state dicts.

`load_pipeline` loads into modules built with the same knobs, strictly,
without `pipeline.load_params` (whose transforms the saved tensors already
carry; the weight-norm fold has no exact inverse), and raises when a knob
differs.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import torch

from audiolcm_torch.diffusion.lcm import LCMConfig
from audiolcm_torch.pipeline import AudioLCMPipeline, PipelineModules, resolve_device

# module name -> the attributes that decide its state dict's layout
LAYOUT_KNOBS = {"dit": ("fuse_qkv",), "clap_text": ("fuse_proj",), "t5": ("fuse_proj",)}


def layout_knobs(modules: PipelineModules) -> dict:
    """{module name: {knob: value}} for every module the pipeline holds."""
    return {name: {k: getattr(m, k) for k in LAYOUT_KNOBS.get(name, ()) if hasattr(m, k)}
            for name, m in modules.items()}


def save_pipeline(path: str, pipeline: AudioLCMPipeline) -> None:
    os.makedirs(path, exist_ok=True)
    torch.save({name: m.state_dict() for name, m in pipeline.modules.items()},
               os.path.join(path, "modules.pt"))
    lcm = pipeline.lcm_config
    meta = {
        "default_latent_len": pipeline.default_latent_len,
        "lcm": {"num_inference_steps": lcm.num_inference_steps,
                "original_inference_steps": lcm.original_inference_steps,
                "guidance_scale": lcm.guidance_scale},
        "num_timesteps": int(pipeline.schedule.num_timesteps),
        "scale_factor": pipeline.scale_factor,
        "compute_dtype": str(pipeline.compute_dtype).removeprefix("torch."),
        "modules": layout_knobs(pipeline.modules),
    }
    with open(os.path.join(path, "pipeline.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_pipeline_params(path: str, device=None) -> Tuple[dict, dict]:
    """({module name: state dict on `device`}, the sidecar)."""
    device = resolve_device(device)
    sds = torch.load(os.path.join(path, "modules.pt"), map_location=device, weights_only=True)
    with open(os.path.join(path, "pipeline.json")) as f:
        return sds, json.load(f)


def load_pipeline(path: str, modules: PipelineModules, schedule=None,
                  device=None) -> AudioLCMPipeline:
    """The saved pipeline on `device` (cuda:0 by default; without a card that
    raises unless device="cpu"), in modules built with the knobs it was
    saved with."""
    device = resolve_device(device)
    sds, meta = load_pipeline_params(path, device)
    if layout_knobs(modules) != meta["modules"]:
        raise ValueError(f"{path} was saved from modules with layout knobs {meta['modules']}; "
                         f"these modules have {layout_knobs(modules)}: build them with the "
                         "same knobs")
    for name, m in modules.items():
        m.load_state_dict(sds[name], strict=True)
    pipe = AudioLCMPipeline(modules, schedule=schedule, lcm_config=LCMConfig(**meta["lcm"]),
                            default_latent_len=meta["default_latent_len"],
                            compute_dtype=getattr(torch, meta["compute_dtype"]), device=device)
    pipe.scale_factor = float(meta["scale_factor"])
    return pipe
