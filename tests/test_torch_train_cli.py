"""The port's training CLI (`audiolcm_torch/cli/train.py`) end to end on
the CPU: a 1-epoch tiny VAE-GAN run and teacher / LCM runs of 4 steps on a
synthetic manifest (mel 16 or 8 bins x 32 frames; 100 val + 8 train rows,
batch 2), each writing metrics.jsonl with finite validation losses and a
checkpoint, as `tests/test_train_cli.py` and `test_train_cli_diffusion.py`
check for the JAX CLI. The diffusion runs fresh-initialise tiny towers and
DiT (no checkpoint) and tokenize with a stub. Also: the config merge
against JAX's, the VAE loss variants' ValueError, validation leaving the
state as it was, and a checkpoint restoring into a fresh state.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch
import yaml

from audiolcm_torch.cli import train as cli
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

VARIANTS = ["contperceptual_multiw", "contperceptual_dis", "contperceptual_mask", "vqperceptual"]


class StubTokenizers:
    max_length = 7

    def __init__(self, *a, **k):
        pass

    def __call__(self, ori, struct):
        ids = torch.arange(self.max_length)[None, :].repeat(len(ori), 1) % 13
        return ids, ids


def _manifest(root, mel_num):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(108):  # first 100 rows = val
        path = root / f"m{i}.npy"
        np.save(path, (rng.standard_normal((mel_num, 32)) * 0.5).astype(np.float32))
        rows.append({"name": f"c{i}", "dataset": "syn", "ori_cap": f"cap {i}",
                     "caption": f"<cap {i}& all>", "mel_path": str(path), "audio_path": "/none",
                     "duration": 32 / 62.5})
    with open(root / "data.tsv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t")
        w.writeheader()
        w.writerows(rows)


def _vae_cfg(root, loss_target="ldm.modules.losses_audio.contperceptual.LPAPSWithDiscriminator"):
    return {"model": {
        "base_learning_rate": 1.0e-4, "target": "ldm.models.autoencoder1d.AutoencoderKL",
        "params": {
            "embed_dim": 4,
            "ddconfig": {"double_z": True, "in_channels": 16, "out_ch": 16, "z_channels": 4,
                         "kernel_size": 5, "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
                         "attn_layers": [], "down_layers": [0], "dropout": 0.0},
            "lossconfig": {"target": loss_target, "params": {
                "disc_start": 0, "kl_weight": 1e-6, "disc_weight": 0.5, "disc_in_channels": 1,
                "disc_loss": "mse", "disc_factor": 2, "r1_reg_weight": 3,
                "disc_hidden_size": 8, "disc_num_layers": 2}}}},
        "data": {"params": {"batch_size": 2, "spec_dir_path": str(root), "mel_num": 16,
                            "spec_len": 32, "spec_crop_len": 32}}}


def _diffusion_cfg(root, target):
    return {"model": {
        "base_learning_rate": 3.0e-6, "target": target,
        "params": {
            "linear_start": 0.00085, "linear_end": 0.012, "timesteps": 1000, "mel_dim": 4,
            "mel_length": 16, "num_ddim_timesteps": 50, "w_min": 4, "w_max": 12,
            "use_lcm": True, "scale_by_std": True,
            "unet_config": {"target": "ldm.modules.diffusionmodules.concatDiT.ConcatDiT2MLP",
                            "params": {"in_channels": 4, "context_dim": 16, "hidden_size": 32,
                                       "num_heads": 4, "depth": 1, "max_len": 64}},
            "first_stage_config": {"target": "ldm.models.autoencoder1d.AutoencoderKL", "params": {
                "embed_dim": 4,
                "ddconfig": {"double_z": True, "in_channels": 8, "out_ch": 8, "z_channels": 4,
                             "kernel_size": 5, "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
                             "attn_layers": [], "down_layers": [0], "dropout": 0.0}}},
            "cond_stage_config": {
                "target": "ldm.modules.encoders.modules.FrozenCLAPFLANEmbedder",
                "params": {"d_proj": 16,
                           "bert_config": {"vocab_size": 30, "hidden_size": 16, "num_layers": 1,
                                           "num_heads": 2, "intermediate_size": 32,
                                           "max_position_embeddings": 16},
                           "t5_config": {"vocab_size": 30, "d_model": 16, "d_kv": 8, "d_ff": 24,
                                         "num_layers": 1, "num_heads": 2}}}}},
        "data": {"params": {"batch_size": 2, "spec_dir_path": str(root), "mel_num": 8}}}


def _run(tmp_path, cfg, extra=()):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    logroot = tmp_path / "logs"
    cli.main(["-b", str(path), "-t", "--max_epochs", "1", "-l", str(logroot), "--device", "cpu",
              *extra])
    (run,) = os.listdir(logroot)
    rundir = logroot / run
    lines = [json.loads(x) for x in open(rundir / "metrics.jsonl")]
    ckpts = sorted(os.listdir(rundir / "checkpoints"))
    return rundir, lines, ckpts


def _val(lines, key):
    vals = [x[key] for x in lines if key in x]
    assert vals and all(np.isfinite(vals)), (key, lines)
    return vals[-1]


def test_vae_train_cli_one_epoch(tmp_path):
    (tmp_path / "data").mkdir()
    _manifest(tmp_path / "data", 16)
    rundir, lines, ckpts = _run(tmp_path, _vae_cfg(tmp_path / "data"))
    assert any("epoch_time_s" in x for x in lines)
    for key in ("val/nll_loss", "val/disc_loss", "val/r1_penalty", "val/d_weight"):
        _val(lines, key)
    assert ckpts == ["4"]  # 8 train rows / batch 2
    sd = torch.load(rundir / "checkpoints" / "4" / "state.pt", weights_only=True)
    assert sd["step"] == 4 and "decoder.conv_out.weight" in sd["vae"]
    assert sd["disc"]["main.3.num_batches_tracked"] == 4  # the fake passes only


@pytest.mark.parametrize("target,val_key", [
    ("ldm.models.diffusion.ddpm_audio.LatentDiffusion_audio", "val/loss_simple"),
    ("ldm.models.diffusion.lcm_audio.LCM_audio", "val/loss")])
def test_diffusion_train_cli_runs(tmp_path, monkeypatch, target, val_key):
    import audiolcm_torch.api as api

    monkeypatch.setattr(api, "Tokenizers", StubTokenizers)
    (tmp_path / "data").mkdir()
    _manifest(tmp_path / "data", 8)
    rundir, lines, ckpts = _run(tmp_path, _diffusion_cfg(tmp_path / "data", target),
                                ["--model.params.ckpt_path", "/nonexistent.ckpt"])
    _val(lines, val_key)
    assert ckpts == ["4"]
    sd = torch.load(rundir / "checkpoints" / "4" / "state.pt", weights_only=True)
    assert sd["step"] == 4


@pytest.mark.parametrize("module", VARIANTS)
def test_vae_loss_variants_raise(tmp_path, module):
    cfg = _vae_cfg(tmp_path, f"ldm.modules.losses_audio.{module}.LPAPSWithDiscriminator")
    with pytest.raises(ValueError, match=module):
        _run(tmp_path, cfg)


def test_unknown_targets_raise(tmp_path):
    with pytest.raises(ValueError, match="unknown lossconfig.target"):
        _run(tmp_path, _vae_cfg(tmp_path, "ldm.modules.losses_audio.other.Loss"))
    cfg = _vae_cfg(tmp_path)
    cfg["model"]["target"] = "ldm.models.nope.Model"
    with pytest.raises(ValueError, match="unknown model target"):
        _run(tmp_path, cfg)


def test_merge_configs_matches_jax(tmp_path):
    from audiolcm_tpu.cli.train import merge_configs as j_merge

    a, b = tmp_path / "a.yaml", tmp_path / "b.yaml"
    a.write_text(yaml.safe_dump({"model": {"x": 1, "p": {"q": [1, 2]}}, "data": {"b": 2}}))
    b.write_text(yaml.safe_dump({"model": {"p": {"r": 3}}, "z": True}))
    over = ["--model.p.q", "[3, 4]", "--data.new.k", "1.5e-3", "stray", "--last"]
    assert cli.merge_configs([str(a), str(b)], over) == j_merge([str(a), str(b)], over)


def test_val_fn_leaves_the_state(tmp_path):
    """Validation runs the training step on val batches and restores the
    modules, optimizers and running statistics after each."""
    from audiolcm_torch.models.discriminators import NLayerDiscriminator2D
    from audiolcm_torch.models.vae1d import AutoencoderKL1D, VAEConfig
    from audiolcm_torch.train import vae_gan

    cfg = vae_gan.VAEGANConfig(disc_start=0, learning_rate=1e-3)
    state = vae_gan.init_vae_gan_state(
        AutoencoderKL1D(VAEConfig(in_channels=16, out_ch=16, ch=32, ch_mult=(1, 2),
                                  num_res_blocks=1, attn_layers=(), z_channels=4, embed_dim=4)),
        NLayerDiscriminator2D(1, 8, 2), cfg)
    _, _, step = vae_gan.make_vae_gan_steps(cfg)
    fn = lambda st, batch, gen: step(st, torch.from_numpy(batch["mel"]), gen)
    before = cli._clone(state.state_dict())
    batches = [{"mel": np.random.default_rng(i).standard_normal((2, 32, 16)).astype(np.float32)}
               for i in range(2)]
    vals = cli._make_val_fn(fn, lambda: iter(batches), "cpu")(state, 0)
    assert set(vals) >= {"val/nll_loss", "val/disc_loss"}
    after = state.state_dict()
    assert after["step"] == 0
    for k, v in before["vae"].items():
        assert torch.equal(v, after["vae"][k])
    for k, v in before["disc"].items():
        assert torch.equal(v, after["disc"][k])
    assert not after["ae_opt"]["state"]
