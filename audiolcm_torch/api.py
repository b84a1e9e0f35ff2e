"""Public inference API, with the JAX package's signatures.

`build_pipeline` turns the reference YAML + checkpoints into a pipeline on
the card; `AudioLCMInfer(prompt, ...)` and `AudioLCMBatchInfer(prompts, ...)`
write 16 kHz wavs to results/test/<prompt-with-dashes>_0.wav, with S=2 LCM
steps and guidance 5.0, batch inference as real batches.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from audiolcm_torch import config as cfg_mod
from audiolcm_torch.data.buckets import DEFAULT_MEL_BUCKETS
from audiolcm_torch.convert import load_state_dict, load_vocoder_dir, split_lcm_state_dict
from audiolcm_torch.diffusion.lcm import LCMConfig
from audiolcm_torch.diffusion.schedule import NoiseSchedule
from audiolcm_torch.models.bigvgan import BigVGAN
from audiolcm_torch.pipeline import (
    AudioLCMPipeline,
    PipelineModules,
    PipelineParams,
    resolve_device,
)

SAMPLE_RATE = 16000


class Tokenizers:
    """Host-side tokenization with HF tokenizers from local directories
    (bert-base-uncased and t5-v1_1-large in the reference)."""

    def __init__(self, bert_path: str, t5_path: str, max_length: int = 77):
        from transformers import AutoTokenizer, T5Tokenizer

        self.clap_tokenizer = AutoTokenizer.from_pretrained(bert_path)
        self.t5_tokenizer = T5Tokenizer.from_pretrained(t5_path)
        self.max_length = max_length

    def __call__(self, ori_captions: Sequence[str], struct_captions: Sequence[str]):
        kw = dict(truncation=True, max_length=self.max_length, padding="max_length",
                  return_tensors="np")
        clap_ids = self.clap_tokenizer(list(ori_captions), **kw)["input_ids"]
        t5_ids = self.t5_tokenizer(list(struct_captions), **kw)["input_ids"]
        return torch.from_numpy(clap_ids), torch.from_numpy(t5_ids)


def build_pipeline(
    config_path: str,
    model_path: Optional[str],
    vocoder_path: str,
    num_inference_steps: int = 2,
    guidance_scale: float = 5.0,
    compute_dtype=None,
    use_flash: Optional[bool] = None,
    fast_snake: bool = False,
    pallas_stage_max_channels: int = 0,
    fuse_text: bool = True,
    fuse_qkv: bool = False,
    profile: Optional[str] = None,
    device=None,
) -> AudioLCMPipeline:
    """Reference YAML + torch checkpoints -> pipeline on `device` (cuda:0
    by default; raises without a card unless device="cpu").

    compute_dtype defaults to bf16 on CUDA and f32 on the CPU. use_flash
    defaults to False (einsum attention), as in the JAX package; True runs
    the DiT's self-attention through the flash kernel
    (nn/flash_attention.py; its plain version on the CPU). fast_snake=True
    swaps the vocoder snakes' cos for a polynomial.
    pallas_stage_max_channels=48 runs the vocoder's two narrowest stages
    through the fused AMP-stage kernel (nn/amp_stage.py); the name is the
    JAX package's knob. The vocoder's other stages route themselves
    (`BigVGAN.stage_route`).

    profile="serving" sets fast_snake=True and pallas_stage_max_channels=48
    (when 0). The JAX package's serving profile also folds batch-1 stages
    into time segments, and its int8 resblock convs are a parity knob; the
    port has neither: the fold works around the TPU's batch-1 layout and was slower
    on the card (batch-1 10 s generate, bf16, eager: 98.8 ms unfolded, 119.8
    ms at fold 8; NVIDIA H100 80GB HBM3, 700.00 W), and the int8 convs
    1.02-1.23x slower than cuDNN's f32 convs (the f32 vocoder on one 10 s
    mel). profile=None or "parity" keeps the defaults.
    """
    if profile == "serving":
        fast_snake = True
        pallas_stage_max_channels = pallas_stage_max_channels or 48
    elif profile not in (None, "parity"):
        raise ValueError(f"unknown profile {profile!r} (expected 'serving' or 'parity')")
    device = resolve_device(device)
    if model_path is None:
        raise ValueError("model_path is required for inference")
    cfg = cfg_mod.parse_diffusion_config(cfg_mod.load_yaml(config_path))
    voc_sd, voc_args = load_vocoder_dir(vocoder_path)
    vocoder = BigVGAN(
        dataclasses.replace(cfg_mod.vocoder_config_from_args(voc_args), fast_snake=fast_snake),
        pallas_stage_max_channels=pallas_stage_max_channels)
    modules = PipelineModules(
        dit=cfg.build_dit(use_flash=bool(use_flash), fuse_qkv=fuse_qkv),
        vae=cfg.build_vae(), vocoder=vocoder,
        clap_text=cfg.build_clap_text(fuse_proj=fuse_text), t5=cfg.build_t5(fuse_proj=fuse_text))
    parts = split_lcm_state_dict(load_state_dict(model_path))
    # LCM checkpoints carry the student under unet.*; teacher-only ones
    # have model.diffusion_model.*
    params = PipelineParams(
        dit=parts["student"] or parts["teacher"], vae=parts["vae"], vocoder=voc_sd,
        clap_text=parts["clap"], t5=parts["t5"], scale_factor=parts["scale_factor"])
    schedule = NoiseSchedule.linear(cfg.timesteps, cfg.linear_start, cfg.linear_end)
    lcm = LCMConfig(num_inference_steps=num_inference_steps,
                    original_inference_steps=cfg.num_ddim_timesteps,
                    guidance_scale=guidance_scale)
    return AudioLCMPipeline(modules, params, schedule, lcm, default_latent_len=cfg.mel_length,
                            compute_dtype=compute_dtype, device=device)


def serving_points(batch_sizes: Sequence[int] = (8,),
                   mel_buckets: Optional[Sequence[int]] = None) -> List[Tuple[int, int]]:
    """The (batch, latent_len) points of the duration lattice
    (`data/buckets.py`), latent = mel // 2."""
    mel_buckets = tuple(mel_buckets) if mel_buckets is not None else DEFAULT_MEL_BUCKETS
    return [(b, mel // 2) for b in batch_sizes for mel in mel_buckets]


def prewarm_buckets(pipeline: AudioLCMPipeline, batch_sizes: Sequence[int] = (8,),
                    mel_buckets: Optional[Sequence[int]] = None, tok_len: int = 77,
                    llm_len: Optional[int] = None) -> dict:
    """Capture the generate once per (batch, mel bucket) serving point as a
    CUDA graph (`aot.CapturedGenerate`) and register it on the pipeline,
    whose `generate` then replays it for int64 ids of shape (batch, tok_len)
    at that latent length (the port's tokenizers return int64 ids); with
    the caption LLM (`PipelineModules.llm`), for its ids of shape (batch,
    llm_len), which a pipeline with that tower requires.

    The counterpart of the JAX package's AOT executables. Graphs do not
    persist across processes: a new process captures again (seconds per
    bucket, the kernels' nvcc build reused from `audiolcm_torch/_build/`).
    All of a pipeline's graphs share one memory pool, captured largest
    first so that the smaller ones reuse its scratch blocks: their replays
    run one at a time on one stream and every replay's outputs are cloned
    out of the pool, so a graph's scratch memory is free whenever another
    graph runs. On a CPU pipeline this raises ValueError: CUDA graphs need
    a card, and no eager stand-in is registered.

    Returns {(batch, latent_len): "captured"}, as JAX returns "loaded" or
    "compiled"; each registered graph holds its capture seconds and the
    pool's bytes after it (`capture_s`, `pool_bytes`)."""
    from audiolcm_torch.aot import CapturedGenerate

    if pipeline.device.type != "cuda":
        raise ValueError("prewarm_buckets captures CUDA graphs and needs a CUDA pipeline; "
                         f"this one runs on {pipeline.device}")
    if (llm_len is None) != (pipeline.modules.llm is None):
        raise ValueError("llm_len is given exactly when the pipeline has a caption LLM")
    if pipeline._graph_pool is None:
        pipeline._graph_pool = torch.cuda.graph_pool_handle()
    points = serving_points(batch_sizes, mel_buckets)
    for b, latent in sorted(points, key=lambda p: p[0] * p[1], reverse=True):
        graph = CapturedGenerate(pipeline, b, latent, tok_len, pool=pipeline._graph_pool,
                                 llm_len=llm_len)
        pipeline._graphs[graph.key] = graph
    return {p: "captured" for p in points}


def _write_wav(path: str, wav: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    from scipy.io import wavfile

    wavfile.write(path, sample_rate, np.clip(np.asarray(wav, dtype=np.float32), -1.0, 1.0))


def _generate_wavs(pipeline: AudioLCMPipeline, tokenizers, ori_prompts: List[str], outdir: str,
                   latent_len: Optional[int] = None, seed: int = 0) -> List[str]:
    os.makedirs(outdir, exist_ok=True)
    struct = [f"<{p}& all>" for p in ori_prompts]
    clap_ids, t5_ids = tokenizers(ori_prompts, struct)
    gen = torch.Generator(device=pipeline.device).manual_seed(seed)
    wav, _ = pipeline.generate(clap_ids, t5_ids, latent_len, generator=gen)
    wav = wav.cpu().numpy()
    paths = []
    for i, p in enumerate(ori_prompts):
        path = os.path.join(outdir, f"{p.strip().replace(' ', '-')}_0.wav")
        _write_wav(path, wav[i])
        paths.append(path)
    return paths


def AudioLCMInfer(
    ori_prompt: str,
    config_path: str = "configs/audiolcm.yaml",
    model_path: str = "./model/000184.ckpt",
    vocoder_path: str = "./model/vocoder",
    bert_path: str = "bert-base-uncased",
    t5_path: str = "t5-v1_1-large",
    outdir: str = "results/test",
    seed: int = 0,
    pipeline: Optional[AudioLCMPipeline] = None,
    tokenizers: Optional[Tokenizers] = None,
    device=None,
) -> str:
    """Single prompt -> wav path."""
    pipeline = pipeline or build_pipeline(config_path, model_path, vocoder_path, device=device)
    tokenizers = tokenizers or Tokenizers(bert_path, t5_path)
    return _generate_wavs(pipeline, tokenizers, [ori_prompt], outdir, seed=seed)[0]


def AudioLCMBatchInfer(
    ori_prompts: List[str],
    config_path: str = "configs/audiolcm.yaml",
    model_path: str = "./model/000184.ckpt",
    vocoder_path: str = "./model/vocoder",
    bert_path: str = "bert-base-uncased",
    t5_path: str = "t5-v1_1-large",
    outdir: str = "results/test",
    seed: int = 0,
    batch_size: int = 8,
    pipeline: Optional[AudioLCMPipeline] = None,
    tokenizers: Optional[Tokenizers] = None,
    device=None,
) -> str:
    """Prompts in device batches of `batch_size` (the last one padded with
    empty prompts); returns the last prompt's wav path."""
    pipeline = pipeline or build_pipeline(config_path, model_path, vocoder_path, device=device)
    tokenizers = tokenizers or Tokenizers(bert_path, t5_path)
    last = None
    for i in range(0, len(ori_prompts), batch_size):
        chunk = list(ori_prompts[i:i + batch_size])
        padded = chunk + [""] * (batch_size - len(chunk))
        paths = _generate_wavs(pipeline, tokenizers, padded, outdir, seed=seed + i)
        last = paths[len(chunk) - 1]
    return last
