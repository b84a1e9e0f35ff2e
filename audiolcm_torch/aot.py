"""Captured generate programs: the port's counterpart of the JAX package's
per-bucket AOT executables (`audiolcm_tpu/aot.py`, `api.prewarm_buckets`).

JAX compiles the generate program once per (batch, mel bucket) and
serialises the executable, so that a later process loads it instead of
tracing and compiling. The eager port has nothing to compile per shape; what
it pays per call is the host's launch of a few thousand kernels. Here the
whole generate, from the token-id buffers to the waveform (text towers, the
LCM steps, the VAE decode and the vocoder with its kernels K1, K5 and K6),
is captured once per bucket as a CUDA graph and replayed per
request.

A graph lives in its process: graphs do not persist across processes. The
port's persistent artefact is the nvcc build of its kernels under
`audiolcm_torch/_build/`, named by a hash of the sources, so the JAX
module's `source_fingerprint`, `load_or_compile` and `purge` have no
counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

from audiolcm_torch import obs


def graph_key(clap_ids, t5_ids, latent_len: int, llm_ids=None) -> tuple:
    """The registry key of the JAX package (`pipeline.generate_jit`): both
    id shapes, both id dtypes (named as numpy and JAX name them, 'int64')
    and the latent length; with the caption LLM's ids, their shape and
    dtype after those."""
    clap_ids, t5_ids = torch.as_tensor(clap_ids), torch.as_tensor(t5_ids)
    name = lambda dt: str(dt).removeprefix("torch.")
    key = (tuple(clap_ids.shape), tuple(t5_ids.shape), name(clap_ids.dtype),
           name(t5_ids.dtype), int(latent_len))
    if llm_ids is None:
        return key
    llm_ids = torch.as_tensor(llm_ids)
    return key + (tuple(llm_ids.shape), name(llm_ids.dtype))


class CapturedGenerate:
    """One (batch, latent_len) generate of `pipeline` captured as a CUDA graph.

    The graph reads static device buffers: the two id tensors (three with
    the caption LLM's, `llm_len` of them per clip), x_T and the
    re-noising draws of every LCM step but the last, and writes the static
    wav and mel. `replay` copies the caller's ids into the buffers (a host
    copy, outside the graph), draws x_T and the per-step noise from the
    caller's generator in the eager sampler's order (`lcm_sample` draws x_T,
    then one tensor per step except the last), replays, and returns clones
    of the outputs: given the same generator, the eager waveform, and no
    later replay overwrites it.

    Before the capture the generate runs once eagerly on a side stream: that builds the kernels' libraries (nvcc at first use), fills
    the device caches the forward reads (T5 buckets, FIR filters, sampler
    scalars) and lets cuDNN and cuBLAS pick their algorithms, none of which
    may happen inside a capture. K1's and K6's weights are packed before
    it, when the pipeline is built (`BigVGAN.pack_stage_weights`), so the
    capture holds no packing: a replay runs each fused stage's kernel
    alone. The recorder (`obs`) holds what the capture recorded (`tally`):
    the kernel launches, which each replay adds to the launch counters, and
    the stages' device timestamps, which each replay writes anew.
    `capture_s` is the seconds of the warm-up and the capture (the
    recorder's `capture` span), `pool_bytes` the bytes the graph's memory
    pool holds after it. The id buffers are int64, what the port's
    tokenizers return.
    """

    llm_ids = None  # the caption LLM's id buffer, where the pipeline has that tower

    def __init__(self, pipeline, batch: int, latent_len: int, tok_len: int = 77, pool=None,
                 llm_len: Optional[int] = None):
        dev = pipeline.device
        if dev.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device; this pipeline runs on "
                             f"{dev} (build it with device='cuda')")
        with obs.span("capture") as span:
            self.pipeline, self.latent_len = pipeline, latent_len
            self.clap_ids = torch.zeros((batch, tok_len), dtype=torch.int64, device=dev)
            self.t5_ids = torch.zeros((batch, tok_len), dtype=torch.int64, device=dev)
            self.llm_ids = None if llm_len is None else torch.zeros(
                (batch, llm_len), dtype=torch.int64, device=dev)
            self.shape = (batch, latent_len, pipeline.modules.dit.in_channels)
            n_noise = max(pipeline.lcm_config.num_inference_steps - 1, 0)
            self.x_T = torch.zeros(self.shape, device=dev)
            self.noise = torch.zeros((n_noise,) + self.shape, device=dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._run()
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            self.graph = torch.cuda.CUDAGraph()
            with obs.capture(dev) as self.tally, torch.cuda.graph(self.graph, pool=pool):
                self.wav, self.mel = self._run()
        self.capture_s = span.seconds
        self.pool_bytes = pool_bytes(self.graph.pool())

    @property
    def key(self) -> tuple:
        return graph_key(self.clap_ids, self.t5_ids, self.latent_len, self.llm_ids)

    @torch.inference_mode()
    def _run(self):
        """The eager generate on the buffers, outside any request."""
        p = self.pipeline
        llm = None if self.llm_ids is None else p.encode_llm_ids(self.llm_ids)
        return p.generate_from_context(p.encode_text_ids(self.clap_ids, self.t5_ids),
                                       self.latent_len, x_T=self.x_T, noise=self.noise,
                                       llm_context=llm)

    def replay(self, clap_ids, t5_ids, generator: Optional[torch.Generator], llm_ids=None):
        """-> (wav, mel) of these ids, both f32 clones of the graph's outputs."""
        dev = self.pipeline.device
        self.clap_ids.copy_(torch.as_tensor(clap_ids))
        self.t5_ids.copy_(torch.as_tensor(t5_ids))
        if self.llm_ids is not None:
            self.llm_ids.copy_(torch.as_tensor(llm_ids))
        self.x_T.copy_(torch.randn(self.shape, generator=generator, device=dev))
        for i in range(self.noise.shape[0]):
            self.noise[i].copy_(torch.randn(self.shape, generator=generator, device=dev))
        with obs.launch(self.tally):
            self.graph.replay()
        return self.wav.clone(), self.mel.clone()


def pool_bytes(pool) -> Optional[int]:
    """Bytes the caching allocator holds in the graph memory pool `pool`
    (the segments of torch.cuda.memory_snapshot that belong to it); None
    when the snapshot does not name the pool of its segments."""
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == tuple(pool))
