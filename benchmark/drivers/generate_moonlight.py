"""Driver of the LCM generate with a third caption tower, a DeepSeek-V3-family
mixture-of-experts LLM (Moonlight-16B-A3B):
`AudioLCMPipeline.generate(clap_ids, t5_ids, latent_len, llm_ids=...)`,
replaying the CUDA graph that `api.prewarm_buckets` captured for the three
id shapes and the latent length; what `AudioLCMInfer` would serve with such
a caption encoder. The rehearsal on the CPU runs the same call eagerly.

The LLM's ids are drawn per request on the host, uniform over its
vocabulary, `llm_tokens` of the mix per clip, from `traffic.derive(seed,
"llm", index)`. The weights: `harness/weights.py`'s rules over the shared
models' layouts, the DiT's with its third embedder and the tower's
(`reference/moe_llm.layout`, HF's key names), one normal draw into one
buffer in that order, each tensor starting on a 128-byte boundary as a
checkpoint's tensors do once loaded (the tower's parameters are views of
the buffer: a tensor at an odd offset would send cuBLAS and K7 to their
unaligned loads). The program is built before the weights are drawn,
so a port that lacks the tower fails at once. On the CPU the tower is cut
to `TINY_LLM` (the rehearsal's widths; every other model is cut by
`harness/rehearsal.py`).
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from benchmark.drivers import generate
from benchmark.harness import program
from benchmark.harness.traffic import derive
from benchmark.harness.weights import DTYPES, _rule
from benchmark.reference import layout, moe_llm, ops, samplers

TINY_LLM = dict(vocab_size=100, hidden_size=32, intermediate_size=48, moe_intermediate_size=16,
                num_hidden_layers=2, num_attention_heads=2, n_routed_experts=8,
                n_shared_experts=1, num_experts_per_tok=2, kv_lora_rank=16,
                qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8)


def tiny_llm(config: dict) -> dict:
    """The configuration with the tower at TINY_LLM's widths and the DiT's
    third embedder reading them."""
    c = copy.deepcopy(config)
    c.update(TINY_LLM)
    c["dit"]["llm_context_dim"] = c["hidden_size"]
    return c


def layouts(config: dict) -> dict:
    """{model: [(key, shape)]}: the shared models', the DiT's with its third
    embedder, and the tower's under "llm"."""
    out = {name: moe_llm.dit_layout(config["dit"]) if name == "dit" else fn(config[name])
           for name, fn in layout.MODELS.items()}
    out["llm"] = moe_llm.layout(config)
    return out


ALIGN = 64  # elements: each tensor's offset in the draw, 128 bytes in bf16


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def make_state_dicts(config: dict, seed: int, device, dtype) -> dict:
    """One normal draw into one flat buffer from the seed, each tensor a view
    that starts at a multiple of ALIGN elements, scaled by its init rule
    (`weights._rule`, the tower's under "llm"). A layer's experts, whose
    sizes are multiples of ALIGN, stay back to back."""
    lay = layouts(config)
    total = sum(_aligned(torch.Size(s).numel()) for entries in lay.values() for _, s in entries)
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
                offset += _aligned(n)
                mean, std = _rule(model, key, shape, extra)
                t.mul_(std)
                if mean:
                    t.add_(mean)
                sd[key] = t
            out[model] = sd
    return out


def build_modules(config: dict, device):
    """The pipeline's modules: the four shared models as
    `program.build_pipeline` builds them, the DiT with its third embedder,
    and the tower on the meta device (its weights are assigned, never
    copied or built in f32)."""
    from audiolcm_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from audiolcm_torch.models.clap_text import BertConfig, ClapTextEncoder
    from audiolcm_torch.models.dit import ConcatDiT2MLP
    from audiolcm_torch.models.moe_llm import MoELLM, MoELLMConfig
    from audiolcm_torch.models.t5_encoder import T5Config, T5Encoder
    from audiolcm_torch.models.vae1d import AutoencoderKL1D, VAEConfig
    from audiolcm_torch.pipeline import PipelineModules

    s, fields, d = config["serving"], program._fields, config["dit"]
    voc_cfg = dataclasses.replace(BigVGANConfig(**fields(BigVGANConfig, config["vocoder"])),
                                  fast_snake=s["fast_snake"])
    with torch.device("meta"):
        llm = MoELLM(MoELLMConfig.from_dict(config))
    with torch.device(device):
        return PipelineModules(
            dit=ConcatDiT2MLP(**{k: d[k] for k in ("in_channels", "context_dim", "hidden_size",
                                                   "depth", "num_heads", "max_len",
                                                   "llm_context_dim")},
                              use_flash=s["use_flash"], fuse_qkv=s["fuse_qkv"]),
            vae=AutoencoderKL1D(VAEConfig(**fields(VAEConfig, config["vae"]))),
            vocoder=BigVGAN(voc_cfg, pallas_stage_max_channels=s["pallas_stage_max_channels"]),
            clap_text=ClapTextEncoder(BertConfig(**fields(BertConfig, config["clap_text"])),
                                      config["clap_text"]["d_proj"], fuse_proj=s["fuse_text"]),
            t5=T5Encoder(T5Config(**fields(T5Config, config["t5"])), fuse_proj=s["fuse_text"]),
            llm=llm)


def build_pipeline(config: dict, modules, sds: dict, device):
    """-> AudioLCMPipeline over `modules` with the state dicts loaded."""
    from audiolcm_torch.diffusion.lcm import LCMConfig
    from audiolcm_torch.diffusion.schedule import NoiseSchedule
    from audiolcm_torch.pipeline import AudioLCMPipeline, PipelineParams

    params = PipelineParams(dit=sds["dit"], vae=sds["vae"], vocoder=sds["vocoder"],
                            clap_text=sds["clap_text"], t5=sds["t5"], llm=sds["llm"],
                            scale_factor=config["scale_factor"])
    sched, smp = config["schedule"], config["sampler"]
    lcm = LCMConfig(num_inference_steps=smp["num_inference_steps"],
                    original_inference_steps=smp["original_inference_steps"],
                    guidance_scale=smp["guidance_scale"])
    return AudioLCMPipeline(modules, params,
                            NoiseSchedule.linear(sched["timesteps"], sched["linear_start"],
                                                 sched["linear_end"]),
                            lcm, compute_dtype=DTYPES[config["serving"]["compute_dtype"]],
                            device=device)


class Driver(generate.Driver):
    def __init__(self, cell, seed: int, device: torch.device):
        super().__init__(cell, seed, device)
        if device.type != "cuda":
            self.config = tiny_llm(self.config)

    def setup(self, warm_requests) -> None:
        modules = build_modules(self.config, self.device)
        self.make_weights()
        self.pipe = build_pipeline(self.config, modules, self.sds, self.device)
        if self.device.type == "cuda":
            from audiolcm_torch.api import prewarm_buckets

            prewarm_buckets(self.pipe, batch_sizes=(self.traffic["batch"],),
                            mel_buckets=tuple(sorted({r.mel_len for r in warm_requests})),
                            llm_len=self.traffic["llm_tokens"])
            self.capture_s = [g.capture_s for g in self.pipe._graphs.values()]
        for r in warm_requests:
            self.run(r)

    def make_weights(self) -> None:
        dtype = DTYPES[self.config["serving"]["compute_dtype"]]
        self.sds = make_state_dicts(self.config, self.seed, self.device, dtype)

    def llm_ids(self, req) -> torch.Tensor:
        """(batch, llm_tokens) int64, uniform over the tower's vocabulary."""
        g = torch.Generator().manual_seed(derive(self.seed, "llm", req.index))
        return torch.randint(0, self.config["vocab_size"],
                             (req.batch, self.traffic["llm_tokens"]), generator=g)

    @torch.inference_mode()
    def _generate(self, req):
        return self.pipe.generate(req.clap_ids, req.t5_ids, req.latent_len,
                                  generator=self.generator(req), llm_ids=self.llm_ids(req))

    @torch.inference_mode()
    def stage_ms(self, req) -> dict:
        """Eager CUDA-event ms of each stage of one request: text towers, the
        caption LLM, sampler + DiT, VAE decode, vocoder."""
        pipe, gen, ids = self.pipe, self.generator(req), self.llm_ids(req)
        out = {"text": generate.event_ms(
            lambda: pipe.encode_text_ids(req.clap_ids, req.t5_ids), 3)}
        out["llm"] = generate.event_ms(lambda: pipe.encode_llm_ids(ids), 3)
        ctx, llm = pipe.encode_text_ids(req.clap_ids, req.t5_ids), pipe.encode_llm_ids(ids)
        sample = lambda: pipe.sample_latent(ctx, req.latent_len, gen, llm_context=llm)
        out["dit"] = generate.event_ms(sample, 3)
        z = sample()
        out["vae"] = generate.event_ms(lambda: pipe.decode_latent(z), 3)
        mel = pipe.decode_latent(z)
        out["vocoder"] = generate.event_ms(lambda: pipe.vocode(mel), 3)
        return out

    @torch.no_grad()
    def reference(self, req, precision: ops.Precision):
        """The plain reference on the same ids, draws and weights."""
        dev = self.device
        n_noise = self.config["sampler"]["num_inference_steps"] - 1
        shape = (req.batch, req.latent_len, self.config["dit"]["in_channels"])
        x_t, noise = samplers.draws(self.generator(req), shape, n_noise, dev)
        with ops.strict_f32():
            return moe_llm.generate(self.sds, self.config, req.clap_ids.to(dev),
                                    req.t5_ids.to(dev), self.llm_ids(req).to(dev), x_t, noise,
                                    precision)
