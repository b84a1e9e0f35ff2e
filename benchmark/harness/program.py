"""The system under test: audiolcm_torch's pipeline, built the way
`api.build_pipeline` builds it, from a configuration file and the
benchmark's reference-layout state dicts (no checkpoint files: the weights
come from the seed). This is the only harness module that imports the
port, and it imports nothing else of the repository."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.harness.weights import DTYPES


def _fields(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: tuple(map(tuple, v)) if k == "resblock_dilation_sizes" else
            tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names}


def build_pipeline(config: dict, sds: dict, device):
    """-> AudioLCMPipeline on `device` with the configuration's serving
    knobs (`serving`), the state dicts loaded through `load_params` (which
    derives the fused projections; the kernels pack their weights)."""
    from audiolcm_torch.diffusion.lcm import LCMConfig
    from audiolcm_torch.diffusion.schedule import NoiseSchedule
    from audiolcm_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from audiolcm_torch.models.clap_text import BertConfig, ClapTextEncoder
    from audiolcm_torch.models.dit import ConcatDiT2MLP
    from audiolcm_torch.models.t5_encoder import T5Config, T5Encoder
    from audiolcm_torch.models.vae1d import AutoencoderKL1D, VAEConfig
    from audiolcm_torch.pipeline import AudioLCMPipeline, PipelineModules, PipelineParams

    s = config["serving"]
    dtype = DTYPES[s["compute_dtype"]]
    voc_cfg = dataclasses.replace(BigVGANConfig(**_fields(BigVGANConfig, config["vocoder"])),
                                  fast_snake=s["fast_snake"])
    with torch.device(device):
        modules = PipelineModules(
            dit=ConcatDiT2MLP(**{k: config["dit"][k] for k in
                                 ("in_channels", "context_dim", "hidden_size", "depth",
                                  "num_heads", "max_len")},
                              use_flash=s["use_flash"], fuse_qkv=s["fuse_qkv"]),
            vae=AutoencoderKL1D(VAEConfig(**_fields(VAEConfig, config["vae"]))),
            vocoder=BigVGAN(voc_cfg, pallas_stage_max_channels=s["pallas_stage_max_channels"]),
            clap_text=ClapTextEncoder(BertConfig(**_fields(BertConfig, config["clap_text"])),
                                      config["clap_text"]["d_proj"], fuse_proj=s["fuse_text"]),
            t5=T5Encoder(T5Config(**_fields(T5Config, config["t5"])), fuse_proj=s["fuse_text"]))
    params = PipelineParams(dit=sds["dit"], vae=sds["vae"], vocoder=sds["vocoder"],
                            clap_text=sds["clap_text"], t5=sds["t5"],
                            scale_factor=config["scale_factor"])
    sched = config["schedule"]
    smp = config["sampler"]
    lcm = LCMConfig(num_inference_steps=smp.get("num_inference_steps", 2),
                    original_inference_steps=smp.get("original_inference_steps", 50),
                    guidance_scale=smp["guidance_scale"])
    return AudioLCMPipeline(modules, params,
                            NoiseSchedule.linear(sched["timesteps"], sched["linear_start"],
                                                 sched["linear_end"]),
                            lcm, compute_dtype=dtype, device=device)


def prewarm(pipeline, batch: int, mel_lens) -> list:
    """The port's serving graphs for these points (`api.prewarm_buckets`);
    -> each graph's capture seconds."""
    from audiolcm_torch.api import prewarm_buckets

    prewarm_buckets(pipeline, batch_sizes=(batch,), mel_buckets=tuple(mel_lens))
    return [g.capture_s for g in pipeline._graphs.values()]
