"""Driver of the generate paths: token ids -> 16 kHz waveforms in host memory.

- sampler "lcm": `AudioLCMPipeline.generate`, replaying the CUDA graph that
  `api.prewarm_buckets` captured for the request's (batch, mel length);
  what `AudioLCMInfer` / `AudioLCMBatchInfer` serve. The rehearsal on the
  CPU has no graphs and runs the same call eagerly.
- sampler "ddim": the teacher path of the generate CLI (`--teacher`):
  `encode_text_ids` of the prompt ids and of the empty prompt's ids at
  batch 1, then `generate_teacher` (DDIM with batch-doubled guidance), eager.

A request ends when its waveform is in host memory (`wav.cpu()`), as
`api._generate_wavs` has it before writing files.
"""

from __future__ import annotations

import gc

import torch

from benchmark.harness import program
from benchmark.harness.weights import DTYPES, make_state_dicts
from benchmark.reference import ops, samplers

# the empty prompt, as bert-base-uncased ([CLS] [SEP] [PAD]...) and
# t5-v1_1-large (</s> <pad>...) tokenize it at max_length 77
EMPTY_IDS = {"clap_text": (101, 102), "t5": (1,)}


def empty_ids(config: dict, tok: int):
    """(clap ids, t5 ids) of the empty prompt, (1, tok) each (taken modulo a
    vocabulary smaller than the real one, as the rehearsal's)."""
    out = []
    for tower in ("clap_text", "t5"):
        ids = torch.zeros((1, tok), dtype=torch.int64)
        given = torch.tensor(EMPTY_IDS[tower]) % config[tower]["vocab_size"]
        ids[0, :len(given)] = given
        out.append(ids)
    return out


def event_ms(fn, iters: int) -> float:
    """CUDA-event ms per call of fn(), after one untimed call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell.config, cell.traffic
        self.kind = self.config["sampler"]["kind"]
        self.capture_s: list = []
        self.uncond = empty_ids(self.config, self.traffic["tokens"])

    # ---------------------------------------------------------------- set-up
    def setup(self, warm_requests) -> None:
        """Weights, the pipeline, the cell's own graphs, one warm request
        per shape (`warm_requests`: one of each mel length)."""
        self.make_weights()
        self.pipe = program.build_pipeline(self.config, self.sds, self.device)
        if self.kind == "lcm" and self.device.type == "cuda":
            self.capture_s = program.prewarm(self.pipe, self.traffic["batch"],
                                             sorted({r.mel_len for r in warm_requests}))
        for r in warm_requests:
            self.run(r)

    def make_weights(self) -> None:
        """The reference-layout state dicts from the seed, on the device."""
        dtype = DTYPES[self.config["serving"]["compute_dtype"]]
        self.sds = make_state_dicts(self.config, self.seed, self.device, dtype)

    def generator(self, req) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(req.draw_seed)

    # ---------------------------------------------------------------- timed path
    @torch.inference_mode()
    def _generate(self, req):
        pipe = self.pipe
        if self.kind == "lcm":
            return pipe.generate(req.clap_ids, req.t5_ids, req.latent_len,
                                 generator=self.generator(req))
        ctx = pipe.encode_text_ids(req.clap_ids, req.t5_ids)
        uc = pipe.encode_text_ids(*self.uncond)
        s = self.config["sampler"]
        return pipe.generate_teacher(ctx, uc, req.latent_len, num_steps=s["num_steps"],
                                     guidance_scale=s["guidance_scale"],
                                     generator=self.generator(req))

    def run(self, req):
        """-> (waveform in host memory, mel on the device)."""
        wav, mel = self._generate(req)
        return wav.cpu(), mel

    # ---------------------------------------------------------------- stages
    @torch.inference_mode()
    def stage_ms(self, req) -> dict:
        """Eager CUDA-event ms of each stage of one request at its shape:
        text towers, sampler + DiT, VAE decode, vocoder."""
        pipe, gen = self.pipe, self.generator(req)
        iters = 1 if self.kind == "ddim" else 3
        out = {"text": event_ms(lambda: pipe.encode_text_ids(req.clap_ids, req.t5_ids), iters)}
        ctx = pipe.encode_text_ids(req.clap_ids, req.t5_ids)
        if self.kind == "lcm":
            sample = lambda: pipe.sample_latent(ctx, req.latent_len, gen)
        else:
            uc = pipe.encode_text_ids(*self.uncond)
            s = self.config["sampler"]
            sample = lambda: pipe.sample_latent_teacher(ctx, uc, req.latent_len, s["num_steps"],
                                                        s["guidance_scale"], False, gen)
        out["dit"] = event_ms(sample, iters)
        z = sample()
        out["vae"] = event_ms(lambda: pipe.decode_latent(z), iters)
        mel = pipe.decode_latent(z)
        out["vocoder"] = event_ms(lambda: pipe.vocode(mel), iters)
        return out

    def free_program(self) -> None:
        """Drops the program and its graphs, and returns their memory, so that
        the reference runs in what is left (the state dicts stay)."""
        self.pipe._graphs.clear()
        del self.pipe
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- reference
    @torch.no_grad()
    def reference(self, req, precision: ops.Precision):
        """The plain reference on the same ids, draws and weights."""
        dev = self.device
        n_noise = (self.config["sampler"]["num_inference_steps"] - 1) if self.kind == "lcm" else 0
        shape = (req.batch, req.latent_len, self.config["dit"]["in_channels"])
        x_t, noise = samplers.draws(self.generator(req), shape, n_noise, dev)
        uncond = [i.to(dev) for i in self.uncond]
        with ops.strict_f32():
            return samplers.generate(self.sds, self.config, req.clap_ids.to(dev),
                                     req.t5_ids.to(dev), x_t, noise, uncond, precision)
