"""Port parity: the vocoder GAN (`audiolcm_torch/train/vocoder_gan.py`,
`models/vocoder_discriminators.py`, `cli/train_vocoder.py`) against
audiolcm_tpu, f32 on the CPU, at tiny widths: BigVGAN of 2 stages from 32
channels (x8 x8, hop 64, 16 mels, one kernel-3 resblock), MPD at periods
(2, 3), MRD at two STFT resolutions, 1024-sample segments, batch 2.

Weights start from one port init, carried to JAX by its `convert_bigvgan`
and a transpose of the discriminators' kernels; results come back through
`convert.vocoder_from_jax`, `mpd_from_jax` and `mrd_from_jax`.
Discriminator outputs and feature maps agree at 1e-5 (feature maps
transposed from JAX's channels-last). One discriminator + generator step
with plain SGD at lr 1 on both sides (optax.sgd(1.0) patched in for
optax.adamw): the metrics at rtol 1e-5 and the updated weights at rtol
1e-5 with atol 1e-5 of the module's largest update. The per-epoch
learning rate equals JAX's schedule exactly.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiolcm_torch.convert import mpd_from_jax, mrd_from_jax, vocoder_from_jax
from audiolcm_torch.dsp.mel import MelConfig as TMelConfig
from audiolcm_torch.dsp.mel import MelSpectrogram as TMel
from audiolcm_torch.models import vocoder_discriminators as t_vd
from audiolcm_torch.models.bigvgan import BigVGAN as TBigVGAN
from audiolcm_torch.models.bigvgan import BigVGANConfig as TBigCfg
from audiolcm_torch.train import vocoder_gan as t_vg
from audiolcm_tpu.dsp.mel import MelConfig as JMelConfig
from audiolcm_tpu.dsp.mel import MelSpectrogram as JMel
from audiolcm_tpu.models import vocoder_discriminators as j_vd
from audiolcm_tpu.models.bigvgan import BigVGAN as JBigVGAN
from audiolcm_tpu.models.bigvgan import BigVGANConfig as JBigCfg
from audiolcm_tpu.convert import convert_bigvgan
from audiolcm_tpu.train import vocoder_gan as j_vg
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

PERIODS = (2, 3)
RESOLUTIONS = ((256, 32, 128), (512, 64, 256))
GEN = dict(num_mels=16, upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
           upsample_initial_channel=32, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1,),))
MEL = dict(sample_rate=16000, n_fft=256, win_size=256, hop_size=64, n_mels=16, fmin=0.0,
           fmax=8000.0)
B, SEG = 2, 1024
FRAMES = SEG // 64


def _disc_to_jax(disc, names) -> dict:
    """A port MPD/MRD's weights as the JAX tree (kernel (kh, kw, in, out))."""
    out = {}
    for name, d in zip(names, disc.discriminators):
        convs = {f"conv_{i}": c for i, c in enumerate(d.convs)}
        convs["conv_post"] = d.conv_post
        out[name] = {k: {"kernel": c.weight.detach().numpy().transpose(2, 3, 1, 0),
                         "bias": c.bias.detach().numpy()} for k, c in convs.items()}
    return out


def _weight_normed(sd) -> dict:
    """A plain state dict in the reference's weight-norm layout (g = the
    norm over dims 1.., v = the weight), which folds back to it exactly."""
    out = {}
    for k, v in sd.items():
        v = v.detach().numpy()
        if k.endswith(".weight") and v.ndim >= 2:
            out[k[:-7] + ".weight_v"] = v
            out[k[:-7] + ".weight_g"] = np.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(1)).reshape(
                (-1,) + (1,) * (v.ndim - 1))
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def nets():
    """Port modules from a seed, and the JAX modules with the same weights."""
    torch.manual_seed(0)
    gen = TBigVGAN(TBigCfg(**GEN))
    mpd = t_vd.MultiPeriodDiscriminator(PERIODS)
    mrd = t_vd.MultiResolutionDiscriminator(RESOLUTIONS)
    gp = convert_bigvgan(_weight_normed(gen.state_dict()), num_upsamples=2, num_kernels=1,
                         dilations_per_block=1)
    mp = _disc_to_jax(mpd, [f"p{p}" for p in PERIODS])
    rp = _disc_to_jax(mrd, [f"r{r[0]}" for r in RESOLUTIONS])
    jmods = (JBigVGAN(JBigCfg(**GEN)), j_vd.MultiPeriodDiscriminator(PERIODS),
             j_vd.MultiResolutionDiscriminator(RESOLUTIONS))
    return jmods, (gp, mp, rp)


def _port(params, pair_batch=False):
    """Port modules loaded from the JAX trees through the converters."""
    gp, mp, rp = (jax.tree.map(np.asarray, t) for t in params)
    gen = TBigVGAN(TBigCfg(**GEN))
    gen.load_state_dict(vocoder_from_jax(gp))
    mpd = t_vd.MultiPeriodDiscriminator(PERIODS, pair_batch=pair_batch)
    mpd.load_state_dict(mpd_from_jax(mp, PERIODS))
    mrd = t_vd.MultiResolutionDiscriminator(RESOLUTIONS, pair_batch=pair_batch)
    mrd.load_state_dict(mrd_from_jax(rp, RESOLUTIONS))
    return gen, mpd, mrd


_JITTED: dict = {}


def _jit(fn):
    """One compiled function per bound method, shared by the cases."""
    return _JITTED.setdefault(fn, jax.jit(fn))


def _wavs(seed):
    r = np.random.default_rng(seed)
    return [(r.standard_normal((B, SEG)) * 0.3).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("pair_batch", [False, True])
def test_discriminators_match_jax(nets, pair_batch):
    """MPD and MRD on (real, fake): logits and every feature map, in
    per-pair and pair-batch mode (the latter against JAX's per-pair run:
    pair-batching is exact); a length the periods do not divide."""
    (_, mpd_j, mrd_j), (_, mp, rp) = nets
    _, mpd, mrd = _port(nets[1], pair_batch)
    y, yh = _wavs(1)
    y, yh = y[:, :SEG - 1], yh[:, :SEG - 1]
    for jm, p, tm in ((mpd_j, mp, mpd), (mrd_j, rp, mrd)):
        want = _jit(jm.apply)({"params": p}, jnp.asarray(y), jnp.asarray(yh))
        got = tm(torch.from_numpy(y), torch.from_numpy(yh))
        for gl, wl in zip(got[:2], want[:2]):
            for g, w in zip(gl, wl):
                np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5)
        for gf, wf in zip(got[2] + got[3], want[2] + want[3]):
            for g, w in zip(gf, wf):
                np.testing.assert_allclose(g.detach().numpy(),
                                           np.moveaxis(np.asarray(w), -1, 1), atol=1e-5)


def test_losses_match_jax(rng):
    r = [rng.standard_normal((2, 7)).astype(np.float32) for _ in range(3)]
    g = [rng.standard_normal((2, 7)).astype(np.float32) for _ in range(3)]
    fr = [[rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(2)]] * 2
    fg = [[rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(2)]] * 2
    T, J = (lambda xs: [torch.from_numpy(x) for x in xs]), (lambda xs: [jnp.asarray(x) for x in xs])
    np.testing.assert_allclose(float(t_vg.lsgan_d_loss(T(r), T(g))),
                               float(j_vg.lsgan_d_loss(J(r), J(g))), rtol=1e-6)
    np.testing.assert_allclose(float(t_vg.lsgan_g_loss(T(g))), float(j_vg.lsgan_g_loss(J(g))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(t_vg.feature_matching_loss([T(f) for f in fr],
                                                                [T(f) for f in fg])),
                               float(j_vg.feature_matching_loss([J(f) for f in fr],
                                                                [J(f) for f in fg])), rtol=1e-6)


def _close_update(got: dict, want: dict, before: dict):
    """rtol 1e-5, atol 1e-5 of the module's largest update: the mel loss's
    log10 near its floor and the feature maps' sums make the gradients
    O(10), and their f32 sums over 10^3 positions round at ~1e-5 of that."""
    scale = max(1.0, max(float((v - before[k]).abs().max()) for k, v in want.items()))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), err_msg=k, rtol=1e-5,
                                   atol=1e-5 * scale)


def test_disc_and_gen_step_match_jax(nets, monkeypatch):
    """One discriminator step then one generator step, SGD lr 1: the four
    generator metrics and the discriminator loss; the updated generator,
    MPD and MRD."""
    (gen_j, mpd_j, mrd_j), (gp, mp, rp) = nets
    monkeypatch.setattr(optax, "adamw", lambda *a, **k: optax.sgd(1.0))
    mcfg = JMelConfig(**{**MEL, "fmax": 8000.0})
    gen_step, disc_step, init_state = j_vg.make_vocoder_gan_steps(
        lambda p, m: gen_j.apply({"params": p}, m),
        lambda p, y, yh: mpd_j.apply({"params": p}, y, yh),
        lambda p, y, yh: mrd_j.apply({"params": p}, y, yh), j_vg.VocoderGANConfig(), mcfg)
    wav, _ = _wavs(2)
    mel = np.asarray(JMel(JMelConfig(**MEL))(jnp.asarray(wav))).transpose(0, 2, 1)
    sj = init_state(gp, mp, rp)
    sj, dm = jax.jit(disc_step)(sj, jnp.asarray(mel), jnp.asarray(wav))
    sj, gm = jax.jit(gen_step)(sj, jnp.asarray(mel), jnp.asarray(wav))

    gen, mpd, mrd = _port(nets[1])
    before = [m.state_dict() for m in (gen, mpd, mrd)]
    before = [{k: v.clone() for k, v in b.items()} for b in before]
    cfg = t_vg.VocoderGANConfig()
    state = t_vg.init_vocoder_gan_state(gen, mpd, mrd, cfg,
                                        optimizer=lambda p: torch.optim.SGD(p, lr=1.0))
    dstep, gstep = t_vg.make_vocoder_gan_steps(cfg, TMel(TMelConfig(**MEL), device="cpu"))
    mel_t, wav_t = torch.from_numpy(mel.copy()), torch.from_numpy(wav)
    state, tdm = dstep(state, mel_t, wav_t)
    state, tgm = gstep(state, mel_t, wav_t)
    assert state.step == int(sj.step) == 1
    for k, v in {**dm, **gm}.items():
        np.testing.assert_allclose(float({**tdm, **tgm}[k]), float(v), rtol=1e-5, err_msg=k)
    _close_update(gen.state_dict(), vocoder_from_jax(jax.tree.map(np.asarray, sj.gen_params)),
                  before[0])
    _close_update(mpd.state_dict(), mpd_from_jax(jax.tree.map(np.asarray, sj.mpd_params),
                                                 PERIODS), before[1])
    _close_update(mrd.state_dict(), mrd_from_jax(jax.tree.map(np.asarray, sj.mrd_params),
                                                 RESOLUTIONS), before[2])


def test_per_epoch_learning_rate_matches_jax():
    """lr * 0.999 ** (n // 1000) at update counts around epoch edges, as
    JAX's schedule computes it, and as the optimizer applies it."""
    captured = {}
    orig = optax.adamw

    def spy(lr, **kw):
        captured["fn"] = lr
        return orig(lr, **kw)

    import unittest.mock as mock

    with mock.patch.object(optax, "adamw", spy):
        j_vg.make_vocoder_gan_steps(None, None, None, j_vg.VocoderGANConfig())
    cfg = t_vg.VocoderGANConfig()
    port = t_vg.lr_schedule(cfg)
    for n in (0, 999, 1000, 1001, 2500, 123456):
        assert port(n) == float(captured["fn"](jnp.asarray(n))), n
    p = torch.nn.Parameter(torch.zeros(1))
    opt = t_vg.make_optimizer(t_vg.VocoderGANConfig(steps_per_epoch=2), [p])
    lrs = []
    for _ in range(5):
        lrs.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(1)
        opt.step()
    sched = t_vg.lr_schedule(t_vg.VocoderGANConfig(steps_per_epoch=2))
    assert lrs == [sched(n) for n in range(5)] and lrs[0] == lrs[1] > lrs[2] == lrs[3]
    assert opt.optimizer.defaults["weight_decay"] == 1e-4


@pytest.fixture(scope="module")
def wav_tsv(tmp_path_factory):
    from scipy.io import wavfile

    root = tmp_path_factory.mktemp("wavs")
    r = np.random.default_rng(0)
    rows = []
    for i, n in enumerate((3000, 800, 5000)):  # the short one is skipped
        path = str(root / f"w{i}.wav")
        wavfile.write(path, 16000, (r.standard_normal(n) * 3000).astype(np.int16))
        rows.append({"name": f"w{i}", "audio_path": path})
    with open(root / "wavs.tsv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["name", "audio_path"], delimiter="\t")
        w.writeheader()
        w.writerows(rows)
    return str(root / "wavs.tsv")


def test_segment_loader_matches_jax(wav_tsv):
    from audiolcm_torch.cli.train_vocoder import segment_loader as t_loader
    from audiolcm_tpu.cli.train_vocoder import segment_loader as j_loader

    jl = j_loader(wav_tsv, 3, SEG, 64, 9, jax.jit(JMel(JMelConfig(**MEL)).__call__))
    tl = t_loader(wav_tsv, 3, SEG, 9, TMel(TMelConfig(**MEL), device="cpu"))
    for _ in range(2):
        g, w = next(tl), next(jl)
        np.testing.assert_array_equal(g["wav"], w["wav"])
        np.testing.assert_allclose(g["mel"], w["mel"], atol=1e-4)


def test_train_vocoder_cli_build_and_fit(wav_tsv, tmp_path):
    """build + fit for 2 steps on the CPU: finite losses in metrics.jsonl, a
    checkpoint; a reference discriminator file with weight-normed convs
    loads into the plain convs."""
    from audiolcm_torch.cli import train_vocoder as cli

    h = {**GEN, "sampling_rate": 16000, "n_fft": 256, "win_size": 256, "hop_size": 64,
         "fmin": 0.0, "fmax": 8000.0, "fmax_for_loss": None, "segment_size": SEG,
         "batch_size": 2, "mpd_reshapes": list(PERIODS), "resolutions": RESOLUTIONS,
         "learning_rate": 1e-4, "adam_b1": 0.8, "adam_b2": 0.99, "lr_decay": 0.999}
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(h))
    args = cli.parse_args(["--config", str(cfg), "--tsv_path", wav_tsv, "--checkpoint_path",
                           str(tmp_path / "run"), "--device", "cpu"])
    built = cli.build(args)
    built["trainer"].log_every = 1
    cli.fit(built, epochs=1, steps_per_epoch=2)
    lines = [json.loads(x) for x in open(tmp_path / "run" / "metrics.jsonl")]
    losses = [x["train/gen_loss"] for x in lines if "train/gen_loss" in x]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert os.listdir(tmp_path / "run" / "checkpoints")
    assert built["state"].step == 2
    # reference layout with weight norm: g * v / ||v|| folded into .weight
    sd = {"mpd": {}, "mrd": {}}
    for name, mod in (("mpd", built["state"].mpd), ("mrd", built["state"].mrd)):
        for k, v in mod.state_dict().items():
            if k.endswith(".weight"):
                norm = v.reshape(v.shape[0], -1).norm(dim=1).reshape(-1, 1, 1, 1)
                sd[name][k[:-7] + ".weight_v"] = v * 2.0
                sd[name][k[:-7] + ".weight_g"] = norm
            else:
                sd[name][k] = v
    torch.save(sd, tmp_path / "do_00000001")
    _, mpd, mrd = cli.build_models(h, "cpu")
    cli.load_reference_discriminators(mpd, mrd, str(tmp_path / "do_00000001"))
    for a, b in ((mpd, built["state"].mpd), (mrd, built["state"].mrd)):
        for (k, v), (k2, v2) in zip(a.state_dict().items(), b.state_dict().items()):
            torch.testing.assert_close(v, v2, rtol=1e-6, atol=1e-7)
