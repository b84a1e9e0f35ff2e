"""End-to-end text-to-audio generation: token ids -> 16 kHz waveform.

    clap_ids (B,77), t5_ids (B,77)
      -> BERT+projection (B,77,1024) | T5 (B,77,1024)  -> (B,154,1024) context
      [llm_ids (B,L) -> a caption LLM's final states (B,L,d_llm), with the
       optional third tower (models/moe_llm.py) and the DiT's third embedder]
      -> S LCM steps of the denoiser (ConcatDiT2MLP; any registry denoiser)
         (or, on the teacher path, 100 DDIM/PLMS steps with batch-doubled CFG)
      -> latent / scale_factor -> VAE decode -> mel (B,T,80)
      -> BigVGAN x256 upsample -> wav (B, 256*T)

Runs on `cuda:0` unless the caller passes another device; with no card and
no device it raises. compute_dtype defaults to bf16 on CUDA and f32 on the
CPU; the sampler state and schedule math stay f32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch import nn

from audiolcm_torch import obs
from audiolcm_torch.aot import graph_key
from audiolcm_torch.convert import assign_state_dict, fold_weight_norms
from audiolcm_torch.diffusion.ddim import DDIMConfig, ddim_sample
from audiolcm_torch.diffusion.lcm import LCMConfig, lcm_sample
from audiolcm_torch.diffusion.plms import plms_sample
from audiolcm_torch.diffusion.schedule import NoiseSchedule
from audiolcm_torch.models.bigvgan import BigVGAN
from audiolcm_torch.models.clap_text import ClapTextEncoder, fuse_bert_state_dict
from audiolcm_torch.models.moe_llm import MoELLM
from audiolcm_torch.models.t5_encoder import T5Encoder, fuse_t5_state_dict
from audiolcm_torch.models.vae1d import AutoencoderKL1D
from audiolcm_torch.nn.attention import fuse_qkv_state_dict


def resolve_device(device=None) -> torch.device:
    """`device`, or cuda:0 when None; raises when None and there is no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("audiolcm_torch runs on a CUDA device and none is available; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda:0")


@dataclasses.dataclass
class PipelineModules:
    """Model definitions; weights arrive through PipelineParams. `dit` is any
    denoiser of the registry (`config.REGISTRY`), served in the
    ConcatDiT2MLP call signature (x, t, context, w_cond). `llm`, the
    optional caption LLM, is best built on the meta device: `load_params`
    assigns its weights without a copy."""

    dit: nn.Module
    vae: AutoencoderKL1D
    vocoder: BigVGAN
    clap_text: Optional[ClapTextEncoder] = None
    t5: Optional[T5Encoder] = None
    llm: Optional[MoELLM] = None

    def items(self):
        return [(f.name, getattr(self, f.name)) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None]


@dataclasses.dataclass
class PipelineParams:
    """Reference-layout state dicts per model, and the latent std rescale."""

    dit: dict
    vae: dict
    vocoder: dict
    clap_text: Optional[dict] = None
    t5: Optional[dict] = None
    scale_factor: float = 1.0
    llm: Optional[dict] = None


def cast_params(params: PipelineParams, dtype) -> PipelineParams:
    """Every floating tensor of the state dicts cast to `dtype`."""
    cast = lambda sd: None if sd is None else {
        k: v.to(dtype) if torch.is_floating_point(v) else v for k, v in sd.items()}
    return dataclasses.replace(params, dit=cast(params.dit), vae=cast(params.vae),
                               vocoder=cast(params.vocoder), clap_text=cast(params.clap_text),
                               t5=cast(params.t5), llm=cast(params.llm))


def load_params(modules: PipelineModules, params: PipelineParams) -> None:
    """Load reference-layout state dicts into the modules, applying the
    load-time reparameterisations their knobs ask for (fused projections,
    folded weight norm)."""
    dit_sd = params.dit
    if getattr(modules.dit, "fuse_qkv", False):
        dit_sd = fuse_qkv_state_dict(dit_sd)
    assign_state_dict(modules.dit, dit_sd)
    assign_state_dict(modules.vae, params.vae)
    assign_state_dict(modules.vocoder, fold_weight_norms(params.vocoder))
    if modules.clap_text is not None:
        sd = params.clap_text
        assign_state_dict(modules.clap_text,
                          fuse_bert_state_dict(sd) if modules.clap_text.fuse_proj else sd)
    if modules.t5 is not None:
        sd = dict(params.t5)
        if "shared.weight" not in sd:
            sd["shared.weight"] = sd["encoder.embed_tokens.weight"]
        assign_state_dict(modules.t5, fuse_t5_state_dict(sd) if modules.t5.fuse_proj else sd)
    if modules.llm is not None:  # the tensors themselves, HF's key names
        modules.llm.load_state_dict(params.llm, strict=True, assign=True)


class AudioLCMPipeline:
    """Holds the modules (on `device`, in `compute_dtype`) and generates."""

    def __init__(self, modules: PipelineModules, params: Optional[PipelineParams] = None,
                 schedule: Optional[NoiseSchedule] = None, lcm_config: LCMConfig = LCMConfig(),
                 default_latent_len: int = 312, compute_dtype=None, device=None):
        with obs.span("init"):  # the module loads and casts: a part of set-up
            self.device = resolve_device(device)
            if compute_dtype is None:
                compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
            self.compute_dtype = compute_dtype
            self.modules = modules
            self.scale_factor = 1.0
            if params is not None:
                load_params(modules, params)
                self.scale_factor = float(params.scale_factor)
            for _, m in modules.items():
                m.to(device=self.device, dtype=compute_dtype).eval().requires_grad_(False)
            if self.device.type == "cuda":
                modules.vocoder.pack_stage_weights()  # K1's and K6's, before any graph capture
                if modules.llm is not None:
                    modules.llm.pack_expert_weights()  # K7's
            self.schedule = schedule if schedule is not None else NoiseSchedule.linear()
            self.lcm_config = lcm_config
            self.default_latent_len = default_latent_len
            # graph_key -> captured generate (api.prewarm_buckets), all in one
            # memory pool; generate prefers these, as the JAX package's
            # generate_jit prefers its AOT executables
            self._graphs: dict = {}
            self._graph_pool = None

    def encode_text_ids(self, clap_ids, t5_ids) -> torch.Tensor:
        """Token ids -> (B, 2L, d) context: CLAP half first, no masks."""
        to = lambda ids: torch.as_tensor(ids, device=self.device).long()
        with obs.stage("text", self.device):
            z1 = self.modules.clap_text(to(clap_ids))
            z2 = self.modules.t5(to(t5_ids))
            return torch.cat([z1, z2], dim=1)

    def encode_llm_ids(self, llm_ids) -> torch.Tensor:
        """Token ids (B, L) -> the caption LLM's final states (B, L, d_llm)."""
        with obs.stage("llm", self.device):
            return self.modules.llm(torch.as_tensor(llm_ids, device=self.device).long())

    def sample_latent(self, context: torch.Tensor, latent_len: int, generator=None,
                      x_T=None, noise=None, llm_context=None) -> torch.Tensor:
        dit = self.modules.dit
        shape = (context.shape[0], latent_len, dit.in_channels)
        denoise = ((lambda x, t, w: dit(x, t, context, w)) if llm_context is None else
                   (lambda x, t, w: dit(x, t, context, w, llm_context)))
        with obs.stage("dit", self.device):
            return lcm_sample(denoise, self.schedule, shape,
                              self.lcm_config, x_T=x_T, noise=noise, generator=generator,
                              dtype=self.compute_dtype, device=self.device)

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        """LCM latent -> mel (B, T, 80), including 1/scale_factor."""
        with obs.stage("vae", self.device):
            return self.modules.vae.decode((z / self.scale_factor).to(self.compute_dtype))

    def vocode(self, mel: torch.Tensor) -> torch.Tensor:
        with obs.stage("vocoder", self.device):
            return self.modules.vocoder(mel)

    def _generator(self, generator, *given):
        """`generator`, or a seed-0 one on the device when something is to
        be drawn (some of the injected `given` is None): none is made when
        nothing is drawn, as inside a CUDA graph capture."""
        if generator is not None or (given and all(g is not None for g in given)):
            return generator
        return torch.Generator(device=self.device).manual_seed(0)

    @torch.inference_mode()
    def generate_from_context(self, context: torch.Tensor, latent_len: Optional[int] = None,
                              generator: Optional[torch.Generator] = None,
                              x_T: Optional[torch.Tensor] = None,
                              noise: Optional[torch.Tensor] = None,
                              llm_context: Optional[torch.Tensor] = None):
        """-> (wav (B, 256*2*latent_len) f32, mel (B, 2*latent_len, 80) f32).
        `llm_context`: the caption LLM's states, for a DiT with a third
        embedder."""
        latent_len = latent_len or self.default_latent_len
        z = self.sample_latent(context.to(self.device), latent_len,
                               self._generator(generator, x_T, noise), x_T, noise, llm_context)
        mel = self.decode_latent(z)
        wav = self.vocode(mel)
        return wav.float(), mel.float()

    @torch.inference_mode()
    def generate(self, clap_ids, t5_ids, latent_len: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 x_T: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                 llm_ids=None):
        """Token ids -> (wav, mel). Noise is drawn from `generator` (a
        torch.Generator on the pipeline's device; seed 0 when None) unless
        x_T and the per-step noise are given. `llm_ids` (B, L), the caption
        LLM's ids, go with a pipeline that has the third tower. When
        `api.prewarm_buckets` captured a graph for these id shapes and
        dtypes and this latent length, and no draw is given, the graph
        replays: it draws from the generator in this path's order and
        returns the same waveform. Each call is one `request` of the
        recorder (`obs`)."""
        latent_len = latent_len or self.default_latent_len
        if (llm_ids is None) != (self.modules.llm is None):
            raise ValueError("llm_ids are given exactly when the pipeline has a caption LLM")
        if x_T is None and noise is None:
            graph = self._graphs.get(graph_key(clap_ids, t5_ids, latent_len, llm_ids))
            if graph is not None:
                with obs.request("replay"):
                    return graph.replay(clap_ids, t5_ids, self._generator(generator), llm_ids)
        with obs.request("eager"):
            context = self.encode_text_ids(clap_ids, t5_ids)
            llm = None if llm_ids is None else self.encode_llm_ids(llm_ids)
            return self.generate_from_context(context, latent_len, generator, x_T, noise, llm)

    def sample_latent_teacher(self, context: torch.Tensor, uncond: torch.Tensor,
                              latent_len: int, num_steps: int = 100,
                              guidance_scale: float = 5.0, use_plms: bool = False,
                              generator=None, x_T=None, noise=None) -> torch.Tensor:
        """DDIM (or PLMS) over the pipeline's DiT with batch-doubled CFG; the
        DiT runs in compute_dtype, the sampler state in f32."""
        dit = self.modules.dit

        def denoise_fn(x, t, ctx):
            return dit(x.to(self.compute_dtype), t, ctx, None).to(torch.float32)

        shape = (context.shape[0], latent_len, dit.in_channels)
        sampler = plms_sample if use_plms else ddim_sample
        # a denoiser that can keeps what it reads of the fixed caption over the steps
        memo = getattr(dit, "caption_memo", contextlib.nullcontext)
        with obs.stage("dit", self.device), memo():
            return sampler(denoise_fn, self.schedule, shape, context, uncond,
                           DDIMConfig(num_steps=num_steps, guidance_scale=guidance_scale),
                           x_T=x_T, noise=noise, generator=generator, device=self.device)

    @torch.inference_mode()
    def generate_teacher(self, context: torch.Tensor, uncond: torch.Tensor,
                         latent_len: Optional[int] = None, num_steps: int = 100,
                         guidance_scale: float = 5.0, use_plms: bool = False,
                         generator: Optional[torch.Generator] = None,
                         x_T: Optional[torch.Tensor] = None,
                         noise: Optional[torch.Tensor] = None):
        """Teacher path (`scripts/txt2audio_for_2cap.py:227-229`): context
        (B, 2L, d) and uncond (1 or B, 2L, d) -> (wav, mel), both f32. It runs
        the pipeline's DiT, the student when the checkpoint has one, as the
        JAX package does. x_T and noise (DDIM: (S, *shape); PLMS:
        (S, 2, *shape)) replace the draws from `generator`. Each call is one
        `request` of the recorder (`obs`)."""
        latent_len = latent_len or self.default_latent_len
        with obs.request("teacher"):
            z = self.sample_latent_teacher(context.to(self.device), uncond.to(self.device),
                                           latent_len, num_steps, guidance_scale, use_plms,
                                           self._generator(generator, x_T, noise), x_T, noise)
            mel = self.decode_latent(z)
            wav = self.vocode(mel)
            return wav.float(), mel.float()
