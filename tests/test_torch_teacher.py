"""The teacher path end to end: generate_teacher (DDIM and PLMS, batch-doubled
CFG, flash attention) against audiolcm_tpu's _generate_teacher, the
teacher config and a teacher-format checkpoint through build_pipeline, the
test-set TSV reader, and the port's txt2audio CLI (--teacher, --plms,
--test-dataset) with stubbed tokenizers.

f32 on the CPU, tiny widths. The JAX x_T draw is recomputed
(split(rng) -> init) and injected; eta = 0, so no other draw is read.
Whole-path tolerance atol 1e-4, the ids -> wav bar of
tests/test_torch_pipeline.py.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from audiolcm_torch import api as t_api
from audiolcm_torch import config as t_cfg
from audiolcm_torch import pipeline as t_pipe
from audiolcm_torch.cli import txt2audio_for_lcm as t_cli
from audiolcm_torch.convert import from_jax
from audiolcm_torch.data.tsvdataset import TSVDatasetStruct
from audiolcm_torch.models import bigvgan as t_voc
from audiolcm_torch.models import clap_text as t_clap
from audiolcm_torch.models import dit as t_dit
from audiolcm_torch.models import t5_encoder as t_t5
from audiolcm_torch.models import vae1d as t_vae
from audiolcm_tpu import api as j_api
from audiolcm_tpu import pipeline as j_pipe
from audiolcm_tpu.data.tsvdataset import TSVDatasetStruct as JaxTSVDatasetStruct
from audiolcm_tpu.models import bigvgan as j_voc
from audiolcm_tpu.models import clap_text as j_clap
from audiolcm_tpu.models import dit as j_dit
from audiolcm_tpu.models import t5_encoder as j_t5
from audiolcm_tpu.models import vae1d as j_vae
from tests.test_api import synthetic_ckpt  # noqa: F401  (module-scoped fixture)
from tests.test_infer_cli import _config_with_dataset, _write_tiny_tsv
from tests.test_torch_pipeline import BERT, DIT, T5, VAE, VOC, StubTokenizers
from tests.test_torch_text import random_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

ATOL = 1e-4
LATENT = 8


def _x_T(rng, shape):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.split(rng)[1], shape,
                                                       dtype=jnp.float32)))


@pytest.fixture(scope="module")
def flash_pipelines():
    """The JAX and port pipelines at tiny widths with use_flash=True, from
    one random JAX parameter tree, and each side's prompt and uncond
    contexts encoded from the same ids."""
    rng_ids = np.random.default_rng(5)
    ids = rng_ids.integers(0, 30, (2, 7)).astype(np.int32)
    uc_ids = rng_ids.integers(0, 30, (1, 7)).astype(np.int32)
    jmods = j_pipe.PipelineModules(
        dit=j_dit.ConcatDiT2MLP(**DIT, use_flash=True),
        vae=j_vae.AutoencoderKL1D(j_vae.VAEConfig(**VAE)),
        vocoder=j_voc.BigVGAN(j_voc.BigVGANConfig(**VOC)),
        clap_text=j_clap.ClapTextEncoder(j_clap.BertConfig(**BERT), d_proj=16),
        t5=j_t5.T5Encoder(j_t5.T5Config(**T5)))
    key, ja = jax.random.PRNGKey(0), jnp.asarray(ids)
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
        k: random_params(v, i + 10) for i, (k, v) in enumerate(shapes.items())})
    jp = j_pipe.AudioLCMPipeline(jmods, params, compute_dtype=jnp.float32)
    j_ctx = (jp.encode_text_ids(ja, ja),
             jp.encode_text_ids(jnp.asarray(uc_ids), jnp.asarray(uc_ids)))

    tmods = t_pipe.PipelineModules(
        dit=t_dit.ConcatDiT2MLP(**DIT, use_flash=True),
        vae=t_vae.AutoencoderKL1D(t_vae.VAEConfig(**VAE)),
        vocoder=t_voc.BigVGAN(t_voc.BigVGANConfig(**VOC)),
        clap_text=t_clap.ClapTextEncoder(t_clap.BertConfig(**BERT), 16, fuse_proj=True),
        t5=t_t5.T5Encoder(t_t5.T5Config(**T5), fuse_proj=True))
    tp = t_pipe.AudioLCMPipeline(tmods, t_pipe.PipelineParams(**from_jax(params)), device="cpu")
    with torch.inference_mode():
        t_ctx = (tp.encode_text_ids(torch.from_numpy(ids), torch.from_numpy(ids)),
                 tp.encode_text_ids(torch.from_numpy(uc_ids), torch.from_numpy(uc_ids)))
    return jp, j_ctx, tp, t_ctx


@pytest.mark.parametrize("use_plms", [False, True])
def test_generate_teacher_matches_jax(flash_pipelines, use_plms):
    """4 steps (PLMS: 5 DiT evaluations) at guidance 5 with the flash path
    on both sides: the JAX Pallas kernel in interpret mode, the port's
    flash_attention (its plain version on the CPU)."""
    jp, j_ctx, tp, t_ctx = flash_pipelines
    rng = jax.random.PRNGKey(9)
    wav_j, mel_j = jp.generate_teacher(rng, *j_ctx, LATENT, num_steps=4, guidance_scale=5.0,
                                       use_plms=use_plms)
    wav, mel = tp.generate_teacher(*t_ctx, LATENT, num_steps=4, guidance_scale=5.0,
                                   use_plms=use_plms, x_T=_x_T(rng, (2, LATENT, 4)))
    assert wav.dtype == mel.dtype == torch.float32
    assert wav.shape == (2, 16 * 64) and mel.shape == (2, 16, 8)
    np.testing.assert_allclose(mel.numpy(), np.asarray(mel_j), atol=ATOL)
    np.testing.assert_allclose(wav.numpy(), np.asarray(wav_j), atol=ATOL)


def _teacher_config(cfg_path, tmp_path):
    """The synthetic LCM config rewritten to configs/teacher.yaml's model
    schema (LatentDiffusion_audio, no LCM fields)."""
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    teacher = t_cfg.load_yaml("configs/teacher.yaml")
    cfg["model"]["target"] = teacher["model"]["target"]
    for k in ("use_lcm", "num_ddim_timesteps", "w_min", "w_max"):
        cfg["model"]["params"].pop(k, None)
    out = tmp_path / "teacher_tiny.yaml"
    out.write_text(yaml.safe_dump(cfg))
    return str(out)


def test_teacher_config_and_checkpoint_match_jax(synthetic_ckpt, tmp_path):  # noqa: F811
    """configs/teacher.yaml parses to the shipped model of
    configs/audiolcm.yaml; a teacher-schema config builds through
    build_pipeline and its 2-step DDIM generate matches the JAX package's
    from the same files (einsum attention, the default)."""
    teacher = t_cfg.parse_diffusion_config(t_cfg.load_yaml("configs/teacher.yaml"))
    lcm = t_cfg.parse_diffusion_config(t_cfg.load_yaml("configs/audiolcm.yaml"))
    assert (teacher.dit, teacher.vae, teacher.cond) == (lcm.dit, lcm.vae, lcm.cond)
    assert (teacher.timesteps, teacher.mel_length) == (1000, 312)

    _, ckpt_path, voc_dir = synthetic_ckpt
    cfg_path = _teacher_config(synthetic_ckpt[0], tmp_path)
    jp = j_api.build_pipeline(cfg_path, ckpt_path, voc_dir)
    ids = np.arange(7)[None, :].repeat(2, 0) % 13
    ctx_j = jp.encode_text_ids(jnp.asarray(ids), jnp.asarray(ids))
    uc_j = jp.encode_text_ids(jnp.asarray(ids[:1]), jnp.asarray(ids[:1]))
    rng = jax.random.PRNGKey(2)
    wav_j, _ = jp.generate_teacher(rng, ctx_j, uc_j, 8, num_steps=2)
    tp = t_api.build_pipeline(cfg_path, ckpt_path, voc_dir, device="cpu")
    assert tp.default_latent_len == 8
    with torch.inference_mode():
        ctx = tp.encode_text_ids(torch.from_numpy(ids), torch.from_numpy(ids))
        uc = tp.encode_text_ids(torch.from_numpy(ids[:1]), torch.from_numpy(ids[:1]))
    wav, _ = tp.generate_teacher(ctx, uc, 8, num_steps=2, x_T=_x_T(rng, (2, 8, 4)))
    np.testing.assert_allclose(wav.numpy(), np.asarray(wav_j), atol=ATOL)


def test_tsv_dataset_matches_jax(tmp_path):
    """Same items as the pandas reader, duplicate-name suffixes and mels
    included."""
    tsv = _write_tiny_tsv(tmp_path, with_mels=True)
    ours, ref = TSVDatasetStruct(tsv, 16, load_mels=True), JaxTSVDatasetStruct(tsv, 16, True)
    assert len(ours) == len(ref) == 3
    for i in range(3):
        a, b = ours[i], ref[i]
        assert a["caption"] == b["caption"] and a["f_name"] == b["f_name"]
        np.testing.assert_array_equal(a["image"], b["image"])
    assert [ours[i]["f_name"] for i in range(3)] == ["dog_0", "dog_1", "cat_0"]


@pytest.fixture
def stub_tokenizers(monkeypatch):
    monkeypatch.setattr(t_api, "Tokenizers", lambda *a, **k: StubTokenizers())


@pytest.mark.parametrize("plms", [False, True])
def test_cli_teacher_path(synthetic_ckpt, tmp_path, stub_tokenizers, plms):  # noqa: F811
    cfg_path, ckpt_path, voc_dir = synthetic_ckpt
    ptxt = tmp_path / "prompt.txt"
    ptxt.write_text("thunder rolls\n")
    outdir = tmp_path / "out"
    t_cli.main(["--prompt_txt", str(ptxt), "-b", cfg_path, "-r", ckpt_path,
                "--vocoder-ckpt", voc_dir, "--outdir", str(outdir), "--W", "8",
                "--batch_size", "1", "--ddim_steps", "4", "--teacher", "--device", "cpu"]
               + (["--plms"] if plms else []))
    from scipy.io import wavfile

    sr, wav = wavfile.read(outdir / "thunder-rolls_0.wav")
    assert sr == 16000 and wav.shape == (128,) and np.all(np.isfinite(wav))


def test_cli_dataset_mode_result_csv(synthetic_ckpt, tmp_path, stub_tokenizers):  # noqa: F811
    """The JAX CLI's names ({name}_sample_{num}_{idx}.wav, duplicate TSV
    names suffixed) and result.csv byte for byte as pandas writes it."""
    cfg_path, ckpt_path, voc_dir = synthetic_ckpt
    cfg_ds = _config_with_dataset(cfg_path, _write_tiny_tsv(tmp_path), tmp_path)
    outdir = tmp_path / "out"
    t_cli.main(["--test-dataset", "audiocaps", "-b", cfg_ds, "-r", ckpt_path,
                "--vocoder-ckpt", voc_dir, "--outdir", str(outdir), "--W", "8",
                "--batch_size", "2", "--n_samples", "2", "--teacher", "--ddim_steps", "2",
                "--device", "cpu"])
    wavs = sorted(f for f in os.listdir(outdir) if f.endswith(".wav"))
    assert wavs == ["cat_sample_0_0.wav", "cat_sample_0_1.wav", "dog_sample_0_0.wav",
                    "dog_sample_0_1.wav", "dog_sample_1_0.wav", "dog_sample_1_1.wav"]
    with open(outdir / "result.csv", newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    assert len(rows) == 6 and list(rows[0]) == ["caption", "audio_path"]
    assert {r["caption"] for r in rows} == {"a dog barks", "a dog howls", "a cat meows"}
    assert all(os.path.exists(r["audio_path"]) for r in rows)
    import pandas as pd

    assert (outdir / "result.csv").read_text() == pd.DataFrame(rows).to_csv(sep="\t",
                                                                             index=False)
