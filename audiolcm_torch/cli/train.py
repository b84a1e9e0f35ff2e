"""Training CLI (`audiolcm_tpu/cli/train.py`; the reference's `python
main.py --base <cfg> -t`).

    python -m audiolcm_torch.cli.train -b configs/autoencoder1d.yaml -t \\
        [--max_epochs N] [-l logs] [--device cpu] [--a.b.c value ...]
    torchrun --nproc_per_node N -m audiolcm_torch.cli.train -b <cfg> -t

Reference `main.py:555-845`: YAMLs merged left to right, `--key value`
dotlist overrides, the trainer chosen by `model.target`, the learning rate
scaled by processes x batch, the logdir layout `<logdir>/<time>_<name>/`
with metrics.jsonl and checkpoints/, resume from a checkpoint (-r):
  ldm.models.diffusion.lcm_audio.LCM_audio              -> LCM distillation
  ldm.models.diffusion.ddpm_audio.LatentDiffusion_audio -> teacher LDM
  ldm.models.autoencoder1d.AutoencoderKL                -> VAE GAN
The VAE loss variants (lossconfig.target contperceptual_multiw / _dis /
_mask, vqperceptual) are not ported yet and raise ValueError naming the
target. Under torchrun each process trains on its card with its shard of
the batches (`parallel/mesh.py`); rank 0 writes the checkpoints and
metrics.jsonl, the other ranks their metrics under rank<r>/. Runs on
--device, the card unless told otherwise; the DiT is built with einsum
attention and every module in f32.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import datetime
import itertools
import os
from typing import List, Optional

import torch

from audiolcm_torch.parallel import mesh

VARIANT_LOSSES = {"contperceptual_multiw": "multiw", "contperceptual_dis": "dis",
                  "contperceptual_mask": "mask", "vqperceptual": "vq"}


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--base", nargs="*", default=[])
    p.add_argument("-t", "--train", action="store_true")
    p.add_argument("-r", "--resume", type=str, default="")
    p.add_argument("-n", "--name", type=str, default="")
    p.add_argument("-l", "--logdir", type=str, default="logs")
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--logger", type=str, default="tensorboard", choices=["tensorboard", "wandb"])
    p.add_argument("--scale_lr", action="store_true", default=True)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:0, or cuda:LOCAL_RANK under torchrun; "
                        "'cpu' runs on the CPU)")
    return p.parse_known_args(argv)


def merge_configs(paths: List[str], overrides: List[str]) -> dict:
    """OmegaConf-style left-to-right merge + `--a.b.c value` dotlist."""
    import yaml

    from audiolcm_torch.config import load_yaml

    def deep_merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                deep_merge(dst[k], v)
            else:
                dst[k] = v
        return dst

    cfg: dict = {}
    for path in paths:
        deep_merge(cfg, load_yaml(path))
    i = 0
    while i < len(overrides):
        key = overrides[i]
        if key.startswith("--") and i + 1 < len(overrides):
            node = cfg
            parts = key[2:].split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = yaml.safe_load(overrides[i + 1])
            i += 2
        else:
            i += 1
    return cfg


def _make_logdir(root: str, name: str, base_paths: List[str]) -> str:
    """`<root>/<time>_<name>/checkpoints`, named on rank 0."""
    now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    cfg_name = name or (os.path.splitext(os.path.basename(base_paths[0]))[0]
                        if base_paths else "run")
    logdir = mesh.broadcast_object(os.path.join(root, f"{now}_{cfg_name}"))
    os.makedirs(os.path.join(logdir, "checkpoints"), exist_ok=True)
    return logdir


def _data_params(cfg: dict) -> dict:
    return cfg.get("data", {}).get("params", {})


def _epochs(loader):
    """loader_factory for Trainer.fit over a set_epoch loader; every rank
    runs the same number of batches."""
    n = mesh.common_count(len(loader))

    def factory(epoch):
        loader.set_epoch(epoch)
        return itertools.islice(iter(loader), n)

    return factory


def _build_loader(cfg: dict, batch_size: int, split: str = "train"):
    """Loader factory (DataModuleFromConfig, `main.py:180-303`):
    `spec_dir_path` -> one bucketed pool; `main_spec_dir_path` +
    `other_spec_dir_path` (teacher.yaml's two pools) -> main-pool batches
    interleaved with random other-pool batches whose struct captions are
    synthesized. Validation interleaves too: (the 100-row main val split,
    the whole other pool). Batches are sharded by rank."""
    from audiolcm_torch.data.datasets import BucketedBatchLoader, SpecDataset, TwoPoolBatchLoader

    dp = _data_params(cfg)
    mel_num = dp.get("mel_num", 80)
    spec_dir = dp.get("spec_dir_path") or dp.get("main_spec_dir_path")
    if spec_dir is None:
        raise ValueError("data.params.spec_dir_path (or main_spec_dir_path) is required for "
                         "training")
    make = lambda d, split_=split, **kw: BucketedBatchLoader(
        SpecDataset(split_, d, mel_num=mel_num, **kw), batch_size,
        num_replicas=mesh.world_size(), rank=mesh.rank(), shuffle=(split == "train"))
    loader = make(spec_dir)
    other_dir = dp.get("other_spec_dir_path")
    if other_dir:
        loader = TwoPoolBatchLoader(loader, make(other_dir, split_="all", synthesize_struct=True))
    return loader


def _build_tile_loader(cfg: dict, batch_size: int, spec_len: int, split: str = "train"):
    """epoch -> fixed-length tile-padded batches over a permutation seeded by
    the epoch (the VAE's loader); batches sharded by rank."""
    import numpy as np

    from audiolcm_torch.data.datasets import SpecDataset, collate_tile

    dp = _data_params(cfg)
    ds = SpecDataset(split, dp["spec_dir_path"], mel_num=dp.get("mel_num", 80))
    starts = list(range(0, len(ds) - batch_size + 1, batch_size))
    n = mesh.common_count(len(starts[mesh.rank()::mesh.world_size()]))

    def loader(epoch):
        order = np.random.default_rng(epoch).permutation(len(ds))
        for i in starts[mesh.rank()::mesh.world_size()][:n]:
            yield collate_tile([ds[j] for j in order[i:i + batch_size]], target_len=spec_len)

    return loader


def _make_val_fn(step_fn, val_batches, device, num_batches: int = 5):
    """validation_step (`ddpm.py:358-365`): the training step's losses on
    the first `num_batches` val batches, each from the state as it is, with
    a generator seeded 1234 + i; the state (modules, optimizers, running
    statistics) is restored after each."""

    def val_fn(state, epoch):
        vals: dict = {}
        for i, batch in zip(range(num_batches), val_batches()):
            saved = _clone(state.state_dict())
            _, metrics = step_fn(state, batch, torch.Generator(device).manual_seed(1234 + i))
            state.load_state_dict(saved)
            for k, v in metrics.items():
                vals.setdefault(k.replace("train/", "val/"), []).append(float(v))
        return {k: sum(v) / len(v) for k, v in vals.items()}

    return val_fn


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


def _trainer(step_fn, state, logdir, args, val_fn):
    """Trainer on rank 0 with checkpoints; on other ranks metrics only, under
    rank<r>/."""
    from audiolcm_torch.train.checkpoints import CheckpointManager
    from audiolcm_torch.train.loop import Trainer

    if mesh.rank() != 0:
        return Trainer(step_fn, state, os.path.join(logdir, f"rank{mesh.rank()}"),
                       val_fn=val_fn, tensorboard=False)
    ckpt = CheckpointManager(os.path.join(logdir, "checkpoints"))  # newest 3, by step
    return Trainer(step_fn, state, logdir, checkpoints=ckpt, val_fn=val_fn,
                   logger=getattr(args, "logger", "tensorboard"))


@contextlib.contextmanager
def _seeded(seed: int):
    """Module initialisation from `seed`, the global generator restored after."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        yield


def main(argv: Optional[List[str]] = None) -> None:
    from audiolcm_torch.pipeline import resolve_device

    args, unknown = parse_args(argv)
    cfg = merge_configs(args.base, unknown)
    device = resolve_device(mesh.local_device(args.device))
    mesh.init_distributed(device)
    target = cfg["model"]["target"]
    logdir = _make_logdir(args.logdir, args.name, args.base)
    ndev = mesh.world_size()
    batch_size = _data_params(cfg).get("batch_size", 8)
    if "autoencoder1d.AutoencoderKL" in target:
        run_vae_training(cfg, args, logdir, ndev, batch_size, device)
    elif "lcm_audio.LCM_audio" in target:
        run_lcm_training(cfg, args, logdir, ndev, batch_size, device)
    elif "ddpm_audio.LatentDiffusion_audio" in target:
        run_teacher_training(cfg, args, logdir, ndev, batch_size, device)
    else:
        raise ValueError(f"unknown model target {target}")


def run_vae_training(cfg, args, logdir, ndev, batch_size, device):
    from audiolcm_torch import config as cfg_mod
    from audiolcm_torch.models.discriminators import NLayerDiscriminator2D
    from audiolcm_torch.train.loop import scale_learning_rate
    from audiolcm_torch.train.vae_gan import VAEGANConfig, init_vae_gan_state, make_vae_gan_steps

    lossconfig = cfg["model"]["params"].get("lossconfig", {})
    loss_params = lossconfig.get("params", {})
    loss_target = lossconfig.get("target", "losses_audio.contperceptual.x")
    loss_module = next((seg for seg in loss_target.split(".") if "perceptual" in seg), "")
    if loss_module in VARIANT_LOSSES:
        raise ValueError(
            f"lossconfig.target {loss_target!r} (the {VARIANT_LOSSES[loss_module]!r} VAE loss "
            "variant) is not ported to audiolcm_torch yet; train it with "
            "audiolcm_tpu.cli.train, or use losses_audio.contperceptual.LPAPSWithDiscriminator")
    if loss_module != "contperceptual":
        raise ValueError(f"unknown lossconfig.target {loss_target!r}; expected one of "
                         "contperceptual[_multiw|_dis|_mask] or vqperceptual")
    gan_cfg = VAEGANConfig(
        disc_start=loss_params.get("disc_start", 80001),
        kl_weight=loss_params.get("kl_weight", 1e-6),
        disc_weight=loss_params.get("disc_weight", 0.5),
        disc_factor=loss_params.get("disc_factor", 2.0),
        r1_weight=loss_params.get("r1_reg_weight", 3.0),
        disc_loss=loss_params.get("disc_loss", "mse"),
        learning_rate=scale_learning_rate(cfg["model"].get("base_learning_rate", 4.5e-6),
                                          batch_size, ndev))
    with _seeded(args.seed):
        vae = cfg_mod.build_from_target(cfg["model"]).to(device)
        disc = NLayerDiscriminator2D(loss_params.get("disc_in_channels", 1),
                                     ndf=loss_params.get("disc_hidden_size", 64),
                                     n_layers=loss_params.get("disc_num_layers", 3)).to(device)
    state = init_vae_gan_state(vae, disc, gan_cfg)
    _, _, vae_gan_step = make_vae_gan_steps(gan_cfg)

    def step_fn(state, batch, generator):
        mel = torch.from_numpy(batch["mel"].transpose(0, 2, 1).copy()).to(device)
        return vae_gan_step(state, mel, generator)

    spec_len = _data_params(cfg).get("spec_len", 624)
    loader = _build_tile_loader(cfg, batch_size, spec_len)
    val_loader = _build_tile_loader(cfg, batch_size, spec_len, split="valid")
    trainer = _trainer(step_fn, state, logdir, args,
                       _make_val_fn(step_fn, lambda: val_loader(0), device))
    # AudioLogger (main.py:452-530): a fixed val batch's inputs once and its
    # reconstructions at every trigger, as .npy (and TensorBoard figures)
    trainer.sample_logger = _make_vae_sample_logger(trainer, val_loader(0), device)
    trainer.fit(loader, num_epochs=args.max_epochs,
                generator=torch.Generator(device).manual_seed(args.seed))


def _make_vae_sample_logger(trainer, val_iterable, device, max_items: int = 4):
    from audiolcm_torch.train.logging import AudioSampleLogger

    batch = next(iter(val_iterable), None)
    if batch is None:
        return None
    fixed = torch.from_numpy(batch["mel"].transpose(0, 2, 1)[:max_items].copy()).to(device)
    audio_log = AudioSampleLogger(trainer.logdir, tb=trainer.tb, max_items=max_items)
    logged_inputs = []

    def sample_logger(state, step):
        if not logged_inputs:
            audio_log(fixed.cpu().numpy(), step, split="inputs")
            logged_inputs.append(step)
        with torch.no_grad():
            recon, _ = state.vae(fixed, torch.Generator(device).manual_seed(0))
        audio_log(recon.cpu().numpy(), step, split="reconstructions")

    return sample_logger


def _load_diffusion_ckpt_parts(cfg, ckpt_path):
    """Every sub-model of an LCM / teacher Lightning checkpoint as a
    reference-layout state dict (the port's layout: no conversion), the
    missing ones fresh (`_fill_missing_parts`)."""
    from audiolcm_torch import config as cfg_mod
    from audiolcm_torch.convert import load_state_dict, split_lcm_state_dict

    sys_cfg = cfg_mod.parse_diffusion_config(cfg)
    if not ckpt_path or not os.path.exists(ckpt_path):
        # teacher.yaml ships no model.params.ckpt_path (the DiT trains from
        # scratch) and DDPM.init_from_ckpt is strict=False (ddpm.py:185-201)
        if ckpt_path:
            print(f"WARNING: checkpoint {ckpt_path!r} not found — fresh-initializing every "
                  "sub-model", flush=True)
        parts = {"scale_factor": 1.0}
    else:
        parts = split_lcm_state_dict(load_state_dict(ckpt_path))
    out = {"sys": sys_cfg, "scale_factor": parts["scale_factor"]}
    for k, src in (("teacher", "teacher"), ("student", "student"), ("target", "target"),
                   ("vae", "vae"), ("clap_text", "clap"), ("t5", "t5")):
        out[k] = parts.get(src) or None
    return _fill_missing_parts(out, sys_cfg)


def _fill_missing_parts(out, sys_cfg, seed=0):
    """A fresh module for every sub-model the checkpoint did not carry (the
    others stay state dicts), with a loud warning (the reference's permissive loading:
    teacher.yaml has no model ckpt_path at all). The teacher DiT from
    scratch is the normal teacher-training path; an LCM distillation
    without a real teacher is for smoke tests."""
    build = {"teacher": sys_cfg.build_dit, "vae": sys_cfg.build_vae,
             "clap_text": sys_cfg.build_clap_text, "t5": sys_cfg.build_t5}
    missing = [k for k in build if out.get(k) is None]
    if missing:
        print(f"WARNING: fresh-initializing sub-models {missing} (not present in the checkpoint)",
              flush=True)
    with _seeded(seed):
        for k in missing:
            out[k] = build[k]()
    return out


def _module(build, part, device):
    """A part (a fresh module, or a state dict loaded into build()) on
    `device`; a module is copied, so one part can seed several modules."""
    from audiolcm_torch.convert import assign_state_dict

    if isinstance(part, torch.nn.Module):
        return copy.deepcopy(part).to(device)
    return assign_state_dict(build(), part).to(device)


def _frozen(build, part, device):
    return _module(build, part, device).eval().requires_grad_(False)


def _make_frozen_stages(sys_cfg, parts, bert_path, t5_path, device, max_length=77):
    """Host tokenization and the frozen text towers and VAE encoder shared by
    the teacher and distillation trainers: (batch_to_device(batch,
    generator, scale_factor) -> (z, context), uncond_context, encode_latent).
    Each rank draws the posterior noise of the global batch and keeps its
    rows."""
    from audiolcm_torch import api
    from audiolcm_torch.models.vae1d import DiagonalGaussian

    tokenizers = api.Tokenizers(bert_path, t5_path, max_length)
    clap = _frozen(sys_cfg.build_clap_text, parts["clap_text"], device)
    t5 = _frozen(sys_cfg.build_t5, parts["t5"], device)
    vae = _frozen(sys_cfg.build_vae, parts["vae"], device)

    @torch.no_grad()
    def encode_context(clap_ids, t5_ids):
        ids = lambda x: torch.as_tensor(x, device=device).long()
        return torch.cat([clap(ids(clap_ids)), t5(ids(t5_ids))], dim=1)

    @torch.no_grad()
    def encode_latent(mel_btc, generator, scale_factor):
        post = DiagonalGaussian(vae.encode_moments(mel_btc))
        noise = mesh.draw_shard(lambda n: torch.randn(
            (n,) + post.mean.shape[1:], generator=generator, device=device), mel_btc.shape[0])
        return post.sample(noise=noise) * scale_factor

    def batch_to_device(batch, generator, scale_factor):
        context = encode_context(*tokenizers(batch["ori_caption"], batch["struct_caption"]))
        mel = torch.from_numpy(batch["mel"].transpose(0, 2, 1).copy()).to(device)
        return encode_latent(mel, generator, scale_factor), context

    return batch_to_device, encode_context(*tokenizers([""], [""])), encode_latent


def _diffusion_fit(cfg, args, logdir, step_fn, state, batch_size, device):
    loader = _build_loader(cfg, batch_size)
    val_loader = _build_loader(cfg, batch_size, split="valid")
    val_n = mesh.common_count(len(val_loader))
    trainer = _trainer(step_fn, state, logdir, args,
                       _make_val_fn(step_fn, lambda: itertools.islice(iter(val_loader), val_n),
                                    device))
    trainer.fit(_epochs(loader), num_epochs=args.max_epochs,
                generator=torch.Generator(device).manual_seed(args.seed))


def run_teacher_training(cfg, args, logdir, ndev, batch_size, device,
                         bert_path="bert-base-uncased", t5_path="t5-v1_1-large"):
    """Teacher LDM training (`configs/teacher.yaml`)."""
    from audiolcm_torch.diffusion.schedule import NoiseSchedule
    from audiolcm_torch.train.loop import scale_learning_rate
    from audiolcm_torch.train.lr_schedules import build_schedule
    from audiolcm_torch.train.teacher import TeacherConfig, init_teacher_state, make_teacher_step

    parts = _load_diffusion_ckpt_parts(cfg, args.resume or cfg["model"]["params"].get("ckpt_path"))
    sys_cfg = parts["sys"]
    schedule = NoiseSchedule.linear(sys_cfg.timesteps, sys_cfg.linear_start, sys_cfg.linear_end)
    batch_to_device, _, _ = _make_frozen_stages(sys_cfg, parts, bert_path, t5_path, device)
    lr = scale_learning_rate(sys_cfg.base_learning_rate, batch_size, ndev)
    tcfg = TeacherConfig(learning_rate=lr, lr_schedule=build_schedule(
        cfg["model"]["params"].get("scheduler_config"), lr))
    state = init_teacher_state(_module(sys_cfg.build_dit, parts["teacher"], device), tcfg)
    state.model = mesh.wrap_ddp(state.model)
    step = make_teacher_step(schedule, tcfg)
    scale_factor = parts["scale_factor"]

    def step_fn(state, batch, generator):
        z, context = batch_to_device(batch, generator, scale_factor)
        return step(state, z, context, generator)

    _diffusion_fit(cfg, args, logdir, step_fn, state, batch_size, device)


def run_lcm_training(cfg, args, logdir, ndev, batch_size, device,
                     bert_path="bert-base-uncased", t5_path="t5-v1_1-large"):
    """LCM consistency distillation (`configs/audiolcm.yaml`). The teacher
    comes from model.params.ckpt_path; student and target start from the
    checkpoint's student and target, else from the teacher
    (`lcm_audio.py:107-114`). scale_by_std: without a scale_factor in the
    checkpoint it is 1/std of the first batch's latents over every rank
    (`lcm_audio.py:123-138`)."""
    from audiolcm_torch.diffusion.schedule import NoiseSchedule
    from audiolcm_torch.train.lcm_distill import (
        Batch,
        LCMDistillConfig,
        init_train_state,
        make_lcm_distill_step,
    )
    from audiolcm_torch.train.loop import scale_learning_rate
    from audiolcm_torch.train.lr_schedules import build_schedule

    parts = _load_diffusion_ckpt_parts(cfg, args.resume or cfg["model"]["params"].get("ckpt_path"))
    sys_cfg = parts["sys"]
    schedule = NoiseSchedule.linear(sys_cfg.timesteps, sys_cfg.linear_start, sys_cfg.linear_end)
    batch_to_device, uncond_context, _ = _make_frozen_stages(sys_cfg, parts, bert_path, t5_path,
                                                             device)
    lr = scale_learning_rate(sys_cfg.base_learning_rate, batch_size, ndev)
    dcfg = LCMDistillConfig(num_ddim_timesteps=sys_cfg.num_ddim_timesteps, w_min=sys_cfg.w_min,
                            w_max=sys_cfg.w_max, learning_rate=lr, lr_schedule=build_schedule(
                                cfg["model"]["params"].get("scheduler_config"), lr))
    teacher = _module(sys_cfg.build_dit, parts["teacher"], device).eval().requires_grad_(False)
    student = _module(sys_cfg.build_dit, parts["student"] or parts["teacher"], device)
    state = init_train_state(student, dcfg)
    if parts["target"]:
        state.target.load_state_dict(parts["target"])
    state.student = mesh.wrap_ddp(state.student)
    step = make_lcm_distill_step(schedule, dcfg)
    scale = {"value": parts["scale_factor"]}

    def step_fn(state, batch, generator):
        z, context = batch_to_device(batch, generator, 1.0)
        if sys_cfg.scale_by_std and scale["value"] == 1.0:
            scale["value"] = float(1.0 / mesh.global_std(z))  # the first batch's std
        return step(state, teacher, Batch(z * scale["value"], context), uncond_context, generator)

    _diffusion_fit(cfg, args, logdir, step_fn, state, batch_size, device)


if __name__ == "__main__":
    main()
