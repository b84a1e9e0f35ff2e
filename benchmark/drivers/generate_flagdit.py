"""Driver of the Flag-DiT teacher: the generate CLI's `--teacher` path
(`generate.Driver`, sampler "ddim") with the denoiser the configuration's
`dit.target` names, TxtFlagLargeDiT, built through the port's registry
(`audiolcm_torch.config.REGISTRY`) with the configuration's serving knobs.

Its weights are drawn by `harness/weights.py`'s rules into the shared
models' layouts and the Flag layout (`reference/flag_dit.layout`, the port's
key names), and its reference is `reference/flag_dit.generate`. The program
is built before the weights are drawn, so a port that cannot build this
denoiser with these knobs fails at once.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.drivers import generate
from benchmark.harness import program
from benchmark.harness.weights import DTYPES, _rule
from benchmark.reference import flag_dit, layout, ops, samplers


def layouts(config: dict) -> dict:
    """{model: [(key, shape)]}: the shared models' and the Flag DiT's, in
    `layout.MODELS`' order."""
    return {name: flag_dit.layout(config["dit"]) if name == "dit" else fn(config[name])
            for name, fn in layout.MODELS.items()}


def make_state_dicts(config: dict, seed: int, device, dtype) -> dict:
    """`weights.make_state_dicts` over `layouts`: one normal draw into one
    flat buffer from the seed, each tensor a view scaled by its init rule."""
    lay = layouts(config)
    total = sum(torch.Size(s).numel() for entries in lay.values() for _, s in entries)
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=torch.Generator(device=device).manual_seed(seed % 2 ** 63))
    extra = config.get("init_scale", {})
    out, offset = {}, 0
    with torch.no_grad():
        for model, entries in lay.items():
            sd = {}
            for key, shape in entries:
                n = torch.Size(shape).numel()
                t = flat[offset:offset + n].view(shape)
                offset += n
                mean, std = _rule(model, key, shape, extra)
                t.mul_(std)
                if mean:
                    t.add_(mean)
                sd[key] = t
            out[model] = sd
    return out


def build_modules(config: dict, device):
    """The pipeline's modules on `device`: the denoiser from the registry with
    the serving knobs, the other four as `program.build_pipeline` builds them."""
    from audiolcm_torch import config as registry
    from audiolcm_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from audiolcm_torch.models.clap_text import BertConfig, ClapTextEncoder
    from audiolcm_torch.models.t5_encoder import T5Config, T5Encoder
    from audiolcm_torch.models.vae1d import AutoencoderKL1D, VAEConfig
    from audiolcm_torch.pipeline import PipelineModules

    s, fields = config["serving"], program._fields
    params = {k: v for k, v in config["dit"].items() if k != "target"}
    voc_cfg = dataclasses.replace(BigVGANConfig(**fields(BigVGANConfig, config["vocoder"])),
                                  fast_snake=s["fast_snake"])
    with torch.device(device):
        return PipelineModules(
            dit=registry.REGISTRY[config["dit"]["target"]](params).build(
                use_flash=s["use_flash"], fuse_qkv=s["fuse_qkv"]),
            vae=AutoencoderKL1D(VAEConfig(**fields(VAEConfig, config["vae"]))),
            vocoder=BigVGAN(voc_cfg, pallas_stage_max_channels=s["pallas_stage_max_channels"]),
            clap_text=ClapTextEncoder(BertConfig(**fields(BertConfig, config["clap_text"])),
                                      config["clap_text"]["d_proj"], fuse_proj=s["fuse_text"]),
            t5=T5Encoder(T5Config(**fields(T5Config, config["t5"])), fuse_proj=s["fuse_text"]))


def build_pipeline(config: dict, modules, sds: dict, device):
    """-> AudioLCMPipeline over `modules` with the state dicts loaded."""
    from audiolcm_torch.diffusion.schedule import NoiseSchedule
    from audiolcm_torch.pipeline import AudioLCMPipeline, PipelineParams

    params = PipelineParams(dit=sds["dit"], vae=sds["vae"], vocoder=sds["vocoder"],
                            clap_text=sds["clap_text"], t5=sds["t5"],
                            scale_factor=config["scale_factor"])
    sched = config["schedule"]
    return AudioLCMPipeline(modules, params,
                            NoiseSchedule.linear(sched["timesteps"], sched["linear_start"],
                                                 sched["linear_end"]),
                            compute_dtype=DTYPES[config["serving"]["compute_dtype"]],
                            device=device)


class Driver(generate.Driver):
    def setup(self, warm_requests) -> None:
        modules = build_modules(self.config, self.device)
        self.make_weights()
        self.pipe = build_pipeline(self.config, modules, self.sds, self.device)
        for r in warm_requests:
            self.run(r)

    def make_weights(self) -> None:
        dtype = DTYPES[self.config["serving"]["compute_dtype"]]
        self.sds = make_state_dicts(self.config, self.seed, self.device, dtype)

    @torch.no_grad()
    def reference(self, req, precision: ops.Precision):
        """The plain reference on the same ids, x_T and weights."""
        dev = self.device
        shape = (req.batch, req.latent_len, self.config["dit"]["in_channels"])
        x_t, _ = samplers.draws(self.generator(req), shape, 0, dev)
        uncond = [i.to(dev) for i in self.uncond]
        with ops.strict_f32():
            return flag_dit.generate(self.sds, self.config, req.clap_ids.to(dev),
                                     req.t5_ids.to(dev), x_t, uncond, precision)
