"""The captured-generate registry (aot.py, api.prewarm_buckets) as far as
the CPU can hold it: the bucket keys against audiolcm_tpu's, the refusal on
a CPU pipeline, and generate preferring a registered entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch import aot as t_aot
from audiolcm_torch import api as t_api
from audiolcm_torch.data.buckets import DEFAULT_MEL_BUCKETS as T_BUCKETS
from audiolcm_torch.models import bigvgan as t_voc
from audiolcm_torch.models import clap_text as t_clap
from audiolcm_torch.models import dit as t_dit
from audiolcm_torch.models import t5_encoder as t_t5
from audiolcm_torch.models import vae1d as t_vae
from audiolcm_torch.pipeline import AudioLCMPipeline, PipelineModules
from audiolcm_tpu.data.buckets import DEFAULT_MEL_BUCKETS as J_BUCKETS
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

# a two-stage vocoder: C=16 then C=8
TINY_VOC = dict(num_mels=8, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                upsample_initial_channel=32)


def _tiny_pipeline():
    """A CPU pipeline at tiny widths with torch's default init (no JAX)."""
    torch.manual_seed(0)
    mods = PipelineModules(
        dit=t_dit.ConcatDiT2MLP(in_channels=4, context_dim=16, hidden_size=32, depth=1,
                                num_heads=4, max_len=64),
        vae=t_vae.AutoencoderKL1D(t_vae.VAEConfig(
            in_channels=8, out_ch=8, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_layers=(),
            down_layers=(0,), kernel_size=5, z_channels=4, embed_dim=4)),
        vocoder=t_voc.BigVGAN(t_voc.BigVGANConfig(**TINY_VOC)),
        clap_text=t_clap.ClapTextEncoder(t_clap.BertConfig(
            vocab_size=30, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
            max_position_embeddings=16), 16),
        t5=t_t5.T5Encoder(t_t5.T5Config(vocab_size=30, d_model=16, d_kv=8, d_ff=24,
                                        num_layers=1, num_heads=2)))
    return AudioLCMPipeline(mods, device="cpu", default_latent_len=8)


def test_prewarm_buckets_raises_on_cpu_pipeline():
    pipe = _tiny_pipeline()
    with pytest.raises(ValueError, match="CUDA"):
        t_api.prewarm_buckets(pipe, batch_sizes=(1,), mel_buckets=(16,))
    with pytest.raises(ValueError, match="CUDA"):
        t_aot.CapturedGenerate(pipe, 1, 8)
    assert pipe._graphs == {}  # no eager stand-in was registered


def test_bucket_keys_match_jax():
    """The serving points are JAX's prewarm keys over the same lattice
    ((batch, mel // 2) for each batch and mel bucket), and the registry key
    of a (batch, 77) id pair is the tuple JAX's generate_jit builds."""
    assert T_BUCKETS == J_BUCKETS
    points = t_api.serving_points((1, 8))
    assert points == [(b, mel // 2) for b in (1, 8) for mel in J_BUCKETS]
    assert t_api.serving_points((8,), (312, 624)) == [(8, 156), (8, 312)]
    for dtype, jdtype in ((torch.int32, jnp.int32), (torch.int64, np.int64)):
        ids, jids = torch.zeros((8, 77), dtype=dtype), np.zeros((8, 77), jdtype)
        jids = jnp.asarray(jids) if jdtype is jnp.int32 else jids
        jax_key = (jids.shape, jids.shape, str(jids.dtype), str(jids.dtype), 312)
        assert t_aot.graph_key(ids, ids, 312) == jax_key


def test_generate_prefers_registered_entry():
    """A registered entry answers generate for its key, with the caller's
    generator (seed 0 when None); another latent length, another id dtype
    or injected draws run the eager path."""
    pipe = _tiny_pipeline()
    ids = torch.zeros((1, 7), dtype=torch.int64)
    calls = []

    class Entry:
        def replay(self, clap_ids, t5_ids, generator, llm_ids=None):
            calls.append(generator)
            return "wav", "mel"

    pipe._graphs[t_aot.graph_key(ids, ids, 8)] = Entry()
    gen = torch.Generator().manual_seed(3)
    assert pipe.generate(ids, ids, 8, generator=gen) == ("wav", "mel")
    assert calls == [gen]
    assert pipe.generate(ids, ids) == ("wav", "mel")  # default latent 8, default generator
    assert isinstance(calls[-1], torch.Generator) and calls[-1].initial_seed() == 0
    n = len(calls)
    wav, mel = pipe.generate(ids, ids, 4)
    assert wav.shape == (1, 8 * 8) and mel.shape == (1, 8, 8)
    pipe.generate(ids.int(), ids.int(), 8)
    pipe.generate(ids, ids, 8, x_T=torch.zeros(1, 8, 4), noise=torch.zeros(1, 1, 8, 4))
    assert len(calls) == n
