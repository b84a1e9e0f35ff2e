"""Data parallelism of the port (`audiolcm_torch/parallel/mesh.py`) in two
real processes on gloo, as `tests/test_distributed.py` holds the JAX
package's two-process run: the rank-sharded loader gives disjoint shards
that cover the data; one LCM distillation step with the student in DDP
gives both ranks the same loss and the same updated student, equal to one
single-process step over the global batch (the ranks draw the global
batch's t, noise and w from one seed and keep their rows). The VAE-GAN
steps (gradients and the adaptive weight's gradients averaged over the
ranks, the discriminator's BatchNorm statistics over the global batch)
and the vocoder GAN's discriminator + generator steps agree with their
single-process steps too, as do those of the "dis" VAE loss variant.
SGD at lr 1 throughout, so an update is the gradient; f32 sums over 2 + 2 rows against 4 rows round
differently, so the bar is rtol 1e-5 / atol 1e-5 (updates of O(1)-O(10),
the VAE's from an L1 sum); the two ranks agree exactly.
"""

import csv
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TOL = dict(rtol=1e-5, atol=1e-5)


def build() -> dict:
    """The global batch and the modules, from seeds (the same on every
    rank and in the single process)."""
    from audiolcm_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from audiolcm_torch.models.dit import ConcatDiT2MLP
    from audiolcm_torch.models.discriminators import NLayerDiscriminator2D
    from audiolcm_torch.models.multi_window_disc import MultiWindowDiscriminatorWrapper
    from audiolcm_torch.models.vae1d import AutoencoderKL1D, VAEConfig
    from audiolcm_torch.models.vocoder_discriminators import (
        MultiPeriodDiscriminator,
        MultiResolutionDiscriminator,
    )

    torch.manual_seed(0)
    g = torch.Generator().manual_seed(1)
    vae_cfg = VAEConfig(in_channels=16, out_ch=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                        attn_layers=(), z_channels=4, embed_dim=4)
    return {
        "dit": ConcatDiT2MLP(4, 16, 32, 2, 4, 64),
        "z": torch.randn(4, 16, 4, generator=g), "ctx": torch.randn(4, 6, 16, generator=g),
        "uc": torch.zeros(1, 6, 16),
        "vae": AutoencoderKL1D(vae_cfg),
        "disc": NLayerDiscriminator2D(1, 8, 2),
        "dis_vae": AutoencoderKL1D(vae_cfg),
        "dis_discs": {"patch": NLayerDiscriminator2D(1, 8, 2),
                      "multi": MultiWindowDiscriminatorWrapper((16, 32), 16, hidden_size=8,
                                                               norm_type="in", reduction="stack")},
        "mel": torch.randn(4, 32, 16, generator=g),
        "vae_noise": torch.randn(4, 16, 4, generator=g),
        "gen": BigVGAN(BigVGANConfig(num_mels=8, upsample_rates=(4, 4),
                                     upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
                                     resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),))),
        "mpd": MultiPeriodDiscriminator((2, 3)),
        "mrd": MultiResolutionDiscriminator(((128, 16, 64),)),
        "voc_mel": torch.randn(4, 16, 8, generator=g),
        "wav": 0.3 * torch.randn(4, 256, generator=g),
    }


def run_steps(m: dict, rows: slice) -> dict:
    """One step of each trainer on rows `rows` of the global batch."""
    from audiolcm_torch.diffusion.schedule import NoiseSchedule
    from audiolcm_torch.dsp.mel import MelConfig, MelSpectrogram
    from audiolcm_torch.parallel import mesh
    from audiolcm_torch.train import lcm_distill as L
    from audiolcm_torch.train import vae_gan, vae_losses_extra, vocoder_gan

    sgd = lambda p: torch.optim.SGD(p, lr=1.0)
    teacher = m["dit"]
    import copy

    state = L.init_train_state(copy.deepcopy(teacher), L.LCMDistillConfig(), optimizer=sgd)
    state.student = mesh.wrap_ddp(state.student)
    step = L.make_lcm_distill_step(NoiseSchedule.linear(), L.LCMDistillConfig())
    state, lm = step(state, teacher.requires_grad_(False),
                     L.Batch(m["z"][rows], m["ctx"][rows]), m["uc"],
                     torch.Generator().manual_seed(5))
    out = {"lcm": {k: float(v) for k, v in lm.items()},
           "student": mesh.unwrap(state.student).state_dict()}

    cfg = vae_gan.VAEGANConfig(disc_start=0)
    vstate = vae_gan.init_vae_gan_state(m["vae"], m["disc"], cfg, optimizer=sgd)
    _, _, vae_gan_step = vae_gan.make_vae_gan_steps(cfg)
    vstate, vm = vae_gan_step(vstate, m["mel"][rows], noise=m["vae_noise"][rows])
    out.update(vae_gan={k: float(v) for k, v in vm.items()}, vae=vstate.vae.state_dict(),
               disc=vstate.disc.state_dict())

    dcfg = vae_losses_extra.VariantConfig(variant="dis", disc_start=0)
    dstate = vae_losses_extra.init_variant_state(m["dis_vae"], m["dis_discs"], dcfg, optimizer=sgd)
    _, _, dis_step = vae_losses_extra.make_variant_gan_steps(dcfg)
    dstate, dm = dis_step(dstate, m["mel"][rows], noise=m["vae_noise"][rows],
                          starts=torch.tensor([21, 3]))
    out.update(dis={k: float(v) for k, v in dm.items()}, dis_vae=dstate.vae.state_dict(),
               dis_discs=dstate.discs.state_dict())

    vcfg = vocoder_gan.VocoderGANConfig()
    mel_fn = MelSpectrogram(MelConfig(n_fft=128, win_size=128, hop_size=16, n_mels=8),
                            device="cpu")
    gstate = vocoder_gan.init_vocoder_gan_state(m["gen"], m["mpd"], m["mrd"], vcfg, optimizer=sgd)
    dstep, gstep = vocoder_gan.make_vocoder_gan_steps(vcfg, mel_fn)
    gstate, dm = dstep(gstate, m["voc_mel"][rows], m["wav"][rows])
    gstate, gm = gstep(gstate, m["voc_mel"][rows], m["wav"][rows])
    out.update(voc={k: float(v) for k, v in {**dm, **gm}.items()},
               voc_gen=gstate.gen.state_dict(), mpd=gstate.mpd.state_dict())
    return out


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _manifest(root):
    rng = np.random.default_rng(0)
    with open(root / "data.tsv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["name", "mel_path", "duration"], delimiter="\t")
        w.writeheader()
        for i in range(12):
            t = 70 + 10 * i
            path = root / f"m{i}.npy"
            np.save(path, rng.standard_normal((8, t)).astype(np.float32))
            w.writerow({"name": f"clip{i}", "mel_path": str(path), "duration": t / 62.5})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp")
    _manifest(root)
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_ddp_worker.py"),
                               str(root)], env=dict(env, RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    return [torch.load(root / f"rank{r}.pt", weights_only=True) for r in range(2)]


@pytest.fixture(scope="module")
def single():
    return run_steps(build(), slice(0, 4))


def test_loader_shards_are_disjoint_and_cover(ranks):
    n0, n1 = set(ranks[0]["names"]), set(ranks[1]["names"])
    assert n0.isdisjoint(n1) and len(n0 | n1) == 12
    assert len(ranks[0]["names"]) + len(ranks[1]["names"]) == 12


def _sd_close(a: dict, b: dict, **tol):
    for k, v in b.items():
        torch.testing.assert_close(a[k], v, **(tol or TOL), msg=lambda m, k=k: f"{k}: {m}")


def test_lcm_step_under_ddp_equals_global_step(ranks, single):
    r0, r1 = ranks
    assert r0["lcm"] == r1["lcm"]
    _sd_close(r0["student"], r1["student"], rtol=0, atol=0)
    for k, v in single["lcm"].items():
        assert r0["lcm"][k] == pytest.approx(v, rel=1e-5), k
    _sd_close(r0["student"], single["student"])


@pytest.mark.parametrize("trainer", ["vae_gan", "voc", "dis"])
def test_gan_steps_average_gradients(ranks, single, trainer):
    """The VAE GAN (generator and discriminator steps: the adaptive weight's
    gradients averaged, the discriminator's BatchNorm over the global batch
    in both train-mode passes, R1's double backward through the all-reduce,
    the running statistics), the vocoder GAN and the "dis" loss variant
    (both towers' adaptive weights, the multi-window clamp over the global
    batch's longest mel)."""
    r0, r1 = ranks
    assert r0[trainer] == r1[trainer]
    for k, v in single[trainer].items():
        assert r0[trainer][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    for sd in {"vae_gan": ("vae", "disc"), "voc": ("voc_gen", "mpd"),
               "dis": ("dis_vae", "dis_discs")}[trainer]:
        _sd_close(r0[sd], r1[sd], rtol=0, atol=0)
        _sd_close(r0[sd], single[sd])
