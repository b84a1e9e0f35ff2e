"""The port's VAE round-trip CLI (`audiolcm_torch/cli/reconstruct_audio.py`)
against the JAX package's (`audiolcm_tpu/cli/reconstruct_audio.py`) on
synthetic reference-layout checkpoints (the VAE and vocoder of
tests/test_api.py's synthetic model, weights from tests/test_convert.py's
helpers) and the three-row test TSV of tests/test_infer_cli.py, on the
CPU: the VAE from an LDM config's first_stage_config with a
`first_stage_model.`-prefixed checkpoint, and as the root model of an
autoencoder config with a VAE-only checkpoint.

The two packages draw the posterior sample from different generators, so
both sides' DiagonalGaussian.sample is patched to the mode, in this test
only. Outputs: the same file names; wavs atol 1e-4 (the ids -> wav bar of
tests/test_torch_pipeline.py), mels atol 2e-5, test/mse_loss to 1e-5.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from audiolcm_torch.cli import reconstruct_audio as t_cli
from audiolcm_torch.models import vae1d as t_vae
from audiolcm_tpu.cli import reconstruct_audio as j_cli
from audiolcm_tpu.models import vae1d as j_vae
from audiolcm_tpu.models.bigvgan import BigVGANConfig
from tests.test_convert import _synthetic_bigvgan_sd, _synthetic_vae_sd
from tests.test_infer_cli import _config_with_dataset, _write_tiny_tsv
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

FIRST_STAGE = {"target": "ldm.models.autoencoder1d.AutoencoderKL", "params": {
    "embed_dim": 4, "ddconfig": {"double_z": True, "in_channels": 8, "out_ch": 8,
                                 "z_channels": 4, "kernel_size": 5, "ch": 32, "ch_mult": [1, 2],
                                 "num_res_blocks": 1, "attn_layers": [], "down_layers": [0],
                                 "dropout": 0.0}}}
VOC_ARGS = {"num_mels": 8, "upsample_rates": [4, 2], "upsample_kernel_sizes": [8, 4],
            "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
            "resblock_dilation_sizes": [[1, 3]], "activation": "snakebeta",
            "snake_logscale": True, "resblock": "1"}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{layout: (config path, checkpoint path)} and the vocoder directory."""
    root = tmp_path_factory.mktemp("recon_ckpts")
    vae_sd = {k: torch.from_numpy(v * 0.05) for k, v in _synthetic_vae_sd(j_vae.VAEConfig(
        in_channels=8, out_ch=8, ch=32, ch_mult=(1, 2), num_res_blocks=1, down_layers=(0,),
        attn_layers=(), kernel_size=5, z_channels=4, embed_dim=4)).items()}
    layouts = {}
    for layout, model, prefix in (
            ("first_stage_config",
             {"target": "ldm.models.diffusion.lcm_audio.LCM_audio",
              "params": {"first_stage_config": FIRST_STAGE}}, "first_stage_model."),
            ("root_model", FIRST_STAGE, "")):
        cfg, ckpt = root / f"{layout}.yaml", root / f"{layout}.ckpt"
        cfg.write_text(yaml.safe_dump({"model": model}))
        torch.save({"state_dict": {prefix + k: v for k, v in vae_sd.items()}}, ckpt)
        layouts[layout] = str(cfg), str(ckpt)
    voc_dir = root / "vocoder"
    voc_dir.mkdir()
    voc_cfg = BigVGANConfig(num_mels=8, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                            resblock_dilation_sizes=((1, 3),))
    torch.save({"generator": {k: torch.from_numpy(v * 0.05)
                              for k, v in _synthetic_bigvgan_sd(voc_cfg).items()}},
               voc_dir / "best_netG.pt")
    (voc_dir / "args.yml").write_text(yaml.safe_dump(VOC_ARGS))
    return layouts, str(voc_dir)


def _run(main, layout, checkpoints, root, extra=()):
    """Run one CLI on `layout` with its test TSV under root; returns the
    output directory and the printed test/mse_loss."""
    (cfg_path, ckpt_path), voc_dir = checkpoints[0][layout], checkpoints[1]
    cfg = _config_with_dataset(cfg_path, _write_tiny_tsv(root, with_mels=True), root)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["-b", cfg, "-r", ckpt_path, "--vocoder-ckpt", voc_dir, "--batch_size", "2",
              "--save_mel", "--outdir", str(root / "out"), *extra])
    return root / "out", float(re.search(r"test/mse_loss: ([0-9.]+)", buf.getvalue())[1])


@pytest.fixture(scope="module")
def jax_outputs(checkpoints, tmp_path_factory):
    """The JAX CLI on the first_stage_config layout, posterior sample = mode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_vae.DiagonalGaussian, "sample", lambda self, rng: self.mean)
        return _run(j_cli.main, "first_stage_config", checkpoints,
                    tmp_path_factory.mktemp("jax_recon"))


@pytest.mark.parametrize("layout", ["first_stage_config", "root_model"])
def test_reconstruct_cli_matches_jax(checkpoints, jax_outputs, tmp_path, monkeypatch, layout):
    """Both layouts hold the same VAE, so both port runs must match the JAX
    run on the first_stage_config layout."""
    monkeypatch.setattr(t_vae.DiagonalGaussian, "sample", lambda self, generator=None: self.mean)
    out, mse = _run(t_cli.main, layout, checkpoints, tmp_path, ("--device", "cpu"))
    j_out, j_mse = jax_outputs
    names = sorted(os.listdir(j_out))
    assert names == sorted(os.listdir(out)) == [
        "cat_0.npy", "cat_0.wav", "dog_0.npy", "dog_0.wav", "dog_1.npy", "dog_1.wav"]
    for name in names:
        a, b = out / name, j_out / name
        if name.endswith(".wav"):
            (sr_a, wa), (sr_b, wb) = wavfile.read(a), wavfile.read(b)
            assert sr_a == sr_b == 16000 and wa.shape == wb.shape == (128,)
            np.testing.assert_allclose(wa, wb, atol=1e-4)
        else:
            ma, mb = np.load(a), np.load(b)
            assert ma.shape == mb.shape == (8, 16)
            np.testing.assert_allclose(ma, mb, atol=2e-5)
    assert mse == pytest.approx(j_mse, abs=1e-5)


def test_roundtrip_draws_from_the_generator():
    """roundtrip() samples the posterior from its generator: the same seed
    gives the same reconstruction, another seed another."""
    from audiolcm_torch.models import bigvgan as t_voc

    torch.manual_seed(0)
    vae = t_vae.AutoencoderKL1D(t_vae.VAEConfig(in_channels=8, out_ch=8, ch=32, ch_mult=(1, 2),
                                                num_res_blocks=1, z_channels=4, embed_dim=4)).eval()
    voc = t_voc.BigVGAN(t_voc.BigVGANConfig(
        num_mels=8, upsample_rates=(2,), upsample_kernel_sizes=(4,), upsample_initial_channel=32,
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),))).eval()
    mel = torch.randn(2, 16, 8)
    run = lambda seed: t_cli.roundtrip(vae, voc, mel, torch.Generator().manual_seed(seed))
    (r0, w0), (r0b, _), (r1, _) = run(0), run(0), run(1)
    assert r0.shape == (2, 16, 8) and w0.shape == (2, 32)
    assert torch.equal(r0, r0b) and not torch.equal(r0, r1)
