"""The port end to end: token ids -> wav against audiolcm_tpu (f32 CPU),
the entry points on a synthetic reference-format checkpoint, from_jax, the
default device, unported knobs, and the import boundary.

JAX noise draws are recomputed (split(rng) -> x_T; split(rng, S) per step)
and injected into the port. Whole-path tolerance atol 1e-4: ~60 f32 ops
deep (two towers, 2 DiT steps, VAE, vocoder), each within the 2e-5 module
bar, after the 1/sqrt(alpha) ~ 15x gain of the t=999 x0 estimate.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch import api as t_api
from audiolcm_torch import pipeline as t_pipe
from audiolcm_torch.convert import (
    clap_text_from_jax,
    dit_from_jax,
    fold_weight_norms,
    from_jax,
    t5_from_jax,
    vae_from_jax,
    vocoder_from_jax,
)
from audiolcm_torch.models import bigvgan as t_voc
from audiolcm_torch.models import clap_text as t_clap
from audiolcm_torch.models import dit as t_dit
from audiolcm_torch.models import t5_encoder as t_t5
from audiolcm_torch.models import vae1d as t_vae
from audiolcm_torch.nn import amp_stage
from audiolcm_torch.nn import attention as t_attn
from audiolcm_tpu import api as j_api
from audiolcm_tpu import convert as j_conv
from audiolcm_tpu import pipeline as j_pipe
from audiolcm_tpu.models import bigvgan as j_voc
from audiolcm_tpu.models import clap_text as j_clap
from audiolcm_tpu.models import dit as j_dit
from audiolcm_tpu.models import t5_encoder as j_t5
from audiolcm_tpu.models import vae1d as j_vae
from tests.test_api import synthetic_ckpt  # noqa: F401  (module-scoped fixture)
from tests.test_convert import _synthetic_bigvgan_sd, _synthetic_dit_sd, _synthetic_vae_sd
from tests.test_torch_text import random_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4
DIT = dict(in_channels=4, context_dim=16, hidden_size=32, depth=1, num_heads=4, max_len=64)
VAE = dict(in_channels=8, out_ch=8, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_layers=(),
           down_layers=(0,), kernel_size=5, z_channels=4, embed_dim=4)
# last stage C=4 at T=1024 for a 16-frame mel: JAX's _pick_stage_tile finds
# tile 512, so the JAX side really runs fused_amp_stage_cl_batched
VOC = dict(num_mels=8, upsample_rates=(4, 4, 4), upsample_kernel_sizes=(8, 8, 8),
           upsample_initial_channel=32)
BERT = dict(vocab_size=30, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
            max_position_embeddings=16)
T5 = dict(vocab_size=30, d_model=16, d_kv=8, d_ff=24, num_layers=1, num_heads=2)
LATENT = 8


def jax_draws(rng, shape, steps=2):
    r, init = jax.random.split(rng)
    x_T = np.array(jax.random.normal(init, shape, dtype=jnp.float32))
    noise = np.stack([np.array(jax.random.normal(k, shape, dtype=jnp.float32))
                      for k in jax.random.split(r, steps)])
    return torch.from_numpy(x_T), torch.from_numpy(noise)


def _ids(b=2, t=7):
    return np.random.default_rng(5).integers(0, 30, (b, t)).astype(np.int32)


def test_generate_matches_jax_end_to_end():
    ids = _ids()
    jmods = j_pipe.PipelineModules(
        dit=j_dit.ConcatDiT2MLP(**DIT), vae=j_vae.AutoencoderKL1D(j_vae.VAEConfig(**VAE)),
        vocoder=j_voc.BigVGAN(j_voc.BigVGANConfig(**VOC), pallas_stage_max_channels=4,
                              pallas_interpret=True),
        clap_text=j_clap.ClapTextEncoder(j_clap.BertConfig(**BERT), d_proj=16),
        t5=j_t5.T5Encoder(j_t5.T5Config(**T5)))
    key = jax.random.PRNGKey(0)
    ja = jnp.asarray(ids)
    shapes = {
        "dit": jax.eval_shape(lambda: jmods.dit.init(
            key, jnp.zeros((1, LATENT, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 14, 16)),
            jnp.zeros((1, 256))))["params"],
        "vae": jax.eval_shape(lambda: jmods.vae.init(key, jnp.zeros((1, 16, 8)), key))["params"],
        "vocoder": jax.eval_shape(lambda: jmods.vocoder.init(key, jnp.zeros((1, 16, 8))))["params"],
        "clap_text": jax.eval_shape(lambda: jmods.clap_text.init(key, ja))["params"],
        "t5": jax.eval_shape(lambda: jmods.t5.init(key, ja))["params"],
    }
    params = j_pipe.PipelineParams(scale_factor=0.5, **{
        k: random_params(v, i) for i, (k, v) in enumerate(shapes.items())})
    jp = j_pipe.AudioLCMPipeline(jmods, params, compute_dtype=jnp.float32)
    rng = jax.random.PRNGKey(3)
    wav_j, mel_j = jp.generate_jit(rng, ja, ja, LATENT)

    tmods = t_pipe.PipelineModules(
        dit=t_dit.ConcatDiT2MLP(**DIT), vae=t_vae.AutoencoderKL1D(t_vae.VAEConfig(**VAE)),
        vocoder=t_voc.BigVGAN(t_voc.BigVGANConfig(**VOC), pallas_stage_max_channels=4),
        clap_text=t_clap.ClapTextEncoder(t_clap.BertConfig(**BERT), 16, fuse_proj=True),
        t5=t_t5.T5Encoder(t_t5.T5Config(**T5), fuse_proj=True))
    tparams = t_pipe.PipelineParams(**from_jax(params))
    half = t_pipe.cast_params(tparams, torch.bfloat16)
    assert half.scale_factor == 0.5 and all(
        v.dtype == torch.bfloat16 for sd in (half.dit, half.vae, half.vocoder, half.t5)
        for v in sd.values())
    tp = t_pipe.AudioLCMPipeline(tmods, tparams, device="cpu")
    assert tp.compute_dtype == torch.float32
    x_T, noise = jax_draws(rng, (2, LATENT, 4))
    wav, mel = tp.generate(torch.from_numpy(ids), torch.from_numpy(ids), LATENT, x_T=x_T,
                           noise=noise)
    assert wav.shape == (2, 16 * 64) and mel.shape == (2, 16, 8)
    np.testing.assert_allclose(mel.numpy(), np.asarray(mel_j), atol=ATOL)
    np.testing.assert_allclose(wav.numpy(), np.asarray(wav_j), atol=ATOL)


class StubTokenizers:
    max_length = 7

    def __call__(self, ori, struct):
        ids = torch.arange(self.max_length)[None, :].repeat(len(ori), 1) % 13
        return ids, ids


def test_build_pipeline_on_reference_checkpoint_matches_jax(synthetic_ckpt, tmp_path):  # noqa: F811
    """The port loads the reference-format checkpoint itself (weight norm
    folded, HF tower keys, fused projections) and generates what the JAX
    package generates from the same files."""
    cfg_path, ckpt_path, voc_dir = synthetic_ckpt
    jp = j_api.build_pipeline(cfg_path, ckpt_path, voc_dir)
    ids = np.arange(7)[None, :].repeat(2, 0) % 13
    rng = jax.random.PRNGKey(1)
    wav_j, _ = jp.generate_jit(rng, jnp.asarray(ids), jnp.asarray(ids), 8)
    tp = t_api.build_pipeline(cfg_path, ckpt_path, voc_dir, device="cpu")
    assert tp.scale_factor == 0.5 and tp.default_latent_len == 8
    x_T, noise = jax_draws(rng, (2, 8, 4))
    wav, _ = tp.generate(torch.from_numpy(ids), torch.from_numpy(ids), 8, x_T=x_T, noise=noise)
    np.testing.assert_allclose(wav.numpy(), np.asarray(wav_j), atol=ATOL)

    outdir = str(tmp_path / "out")
    last = t_api.AudioLCMBatchInfer(
        ["dog barks", "cat meows", "rain falls"], config_path=cfg_path, model_path=ckpt_path,
        vocoder_path=voc_dir, outdir=outdir, batch_size=2, pipeline=tp,
        tokenizers=StubTokenizers())
    assert last.endswith("rain-falls_0.wav") and len(os.listdir(outdir)) >= 3
    path = t_api.AudioLCMInfer("a dog barks", outdir=outdir, pipeline=tp,
                               tokenizers=StubTokenizers())
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    assert sr == 16000 and data.shape == (128,)


def test_serving_profile_knobs(synthetic_ckpt):  # noqa: F811
    cfg_path, ckpt_path, voc_dir = synthetic_ckpt
    tp = t_api.build_pipeline(cfg_path, ckpt_path, voc_dir, profile="serving", device="cpu")
    voc = tp.modules.vocoder
    assert voc.config.fast_snake and voc.pallas_stage_max_channels == 48
    assert tp.modules.clap_text.fuse_proj and tp.modules.t5.fuse_proj
    with pytest.raises(ValueError, match="profile"):
        t_api.build_pipeline(cfg_path, ckpt_path, voc_dir, profile="fast", device="cpu")
    attns = lambda p: [m for m in p.modules.dit.modules()
                       if isinstance(m, t_attn.MultiHeadSelfAttention)]
    assert attns(tp) and not any(m.use_flash for m in attns(tp))  # einsum by default
    flash = t_api.build_pipeline(cfg_path, ckpt_path, voc_dir, use_flash=True, device="cpu")
    assert attns(flash) and all(m.use_flash for m in attns(flash))
    # item 16: CUDA graphs need a card; a CPU pipeline is refused
    with pytest.raises(ValueError, match="CUDA"):
        t_api.prewarm_buckets(tp)


def test_from_jax_round_trip():
    """reference-layout state dict -> JAX convert_* -> from_jax gives back
    the same tensors (weight norm folded for the vocoder)."""
    def same(got, ref):
        assert set(got) <= set(ref), sorted(set(got) - set(ref))[:5]
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k], np.float32), err_msg=k)

    dit_sd = _synthetic_dit_sd(4, 16, 32, 2, 64)
    same(dit_from_jax(j_conv.convert_dit(dit_sd, depth=2)), dit_sd)
    jd = j_conv.convert_dit(dit_sd, depth=2)
    from audiolcm_tpu.nn.attention import fuse_attention_params

    same(dit_from_jax(fuse_attention_params(jd)), dit_sd)

    vae_cfg = j_vae.VAEConfig(**VAE)
    vae_sd = _synthetic_vae_sd(vae_cfg)
    got = vae_from_jax(j_conv.convert_vae(vae_sd, num_levels=2, num_res_blocks=1,
                                          down_layers=(0,), attn_layers=()))
    same(got, vae_sd)
    assert set(got) == set(t_vae.AutoencoderKL1D(t_vae.VAEConfig(**VAE)).state_dict())

    voc_cfg = j_voc.BigVGANConfig(**VOC)
    voc_sd = _synthetic_bigvgan_sd(voc_cfg)
    folded = {k: v.numpy() for k, v in fold_weight_norms(
        {k: torch.from_numpy(v) for k, v in voc_sd.items()}).items()}
    got = vocoder_from_jax(j_conv.convert_bigvgan(voc_sd, num_upsamples=3))
    assert set(got) == set(folded)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), folded[k], rtol=1e-6, atol=1e-6, err_msg=k)

    bert = {k: v.numpy() for k, v in t_clap.ClapTextEncoder(
        t_clap.BertConfig(**BERT), 16).state_dict().items()}
    jb = {"bert": j_conv.convert_bert({k[5:]: v for k, v in bert.items() if k.startswith("base.")},
                                      num_layers=1),
          "projection": {"linear1": {"kernel": bert["projection.linear1.weight"].T},
                         "linear2": {"kernel": bert["projection.linear2.weight"].T},
                         "layer_norm": {"scale": bert["projection.layer_norm.weight"],
                                        "bias": bert["projection.layer_norm.bias"]}}}
    same(clap_text_from_jax(jb), bert)
    t5 = {k: v.numpy() for k, v in t_t5.T5Encoder(t_t5.T5Config(**T5)).state_dict().items()}
    same(t5_from_jax(j_conv.convert_t5_encoder(t5, num_layers=1)), t5)


def test_entry_points_default_to_cuda():
    """No device -> cuda:0; without a card that raises instead of running
    on the CPU."""
    mods = t_pipe.PipelineModules(
        dit=t_dit.ConcatDiT2MLP(**DIT), vae=t_vae.AutoencoderKL1D(t_vae.VAEConfig(**VAE)),
        vocoder=t_voc.BigVGAN(t_voc.BigVGANConfig(**VOC)))
    if torch.cuda.is_available():
        assert t_pipe.AudioLCMPipeline(mods).device == torch.device("cuda:0")
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_pipe.AudioLCMPipeline(mods)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_api.build_pipeline("unused.yaml", "unused.ckpt", "unused")
    # the loaders and the entry points of slice 12
    from audiolcm_torch import native_ckpt
    from audiolcm_torch.models import lpaps, vggish
    from audiolcm_torch.tools import train_micro

    for call in (lambda: lpaps.load_lpaps({}), lambda: vggish.load_vggish({}),
                 lambda: native_ckpt.load_pipeline("unused", mods),
                 train_micro.vae_gan_setup, train_micro.vocoder_gan_setup,
                 train_micro.lcm_distill_setup, lambda: train_micro.main(["vae"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


FORBIDDEN = {"jax", "flax", "audiolcm_tpu"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((REPO / "audiolcm_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        bad = FORBIDDEN & set(_imports(f))
        assert not bad, f"{f.relative_to(REPO)} imports {bad}"
    code = ("import pkgutil, importlib, sys, audiolcm_torch\n"
            "for m in pkgutil.walk_packages(audiolcm_torch.__path__, 'audiolcm_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "sys.path.insert(0, '.'); import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'audiolcm_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
