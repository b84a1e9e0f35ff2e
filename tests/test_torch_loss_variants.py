"""Port parity: the VAE loss variants (`audiolcm_torch/models/
multi_window_disc.py`, `models/lpaps.py`, `train/vae_losses_extra.py`)
against audiolcm_tpu, f32 on the CPU, at tiny widths (mel 16 x 32 frames,
VAE ch 32 with ch_mult (1, 2), PatchGAN ndf 8 with 2 strided layers,
multi-window hidden 8).

One random port init feeds both sides: the VAE through JAX's own
`convert_vae`, the PatchGAN through the inverse of
`convert.patchgan_from_jax`, the multi-window towers through
`convert.multi_window_to_jax`; results come back through the port's
converters. JAX draws each window start inside its module with
`jax.random.randint`; the tests pin the draws by patching that function in
this process for the call (a cycle over the windows' starts), and hand the
same starts to the port. Train-mode towers run without dropout on both
sides (flax's Dropout and the port's `_dropout2d` patched out), so the
BatchNorm statistics and the spectral norm's u and sigma are compared;
`test_dropout2d_drops_whole_channels` holds the port's channel dropout.

The instance-norm ("in") towers use windows (16, 32): at window 8 the last
block normalises over 1 x 2 positions, where a variance of two numbers
turns f32 rounding in the convs into 1e-5-scale differences (the fast
variance of flax, which the port copies, matches JAX's to 6e-8 on the
same inputs).

The variant steps (here multiw and dis; mask, vq and the LPAPS case in
`test_torch_loss_variant_steps.py`, which shares `check_variant_step`)
run one generator and one discriminator step with SGD at
lr 1 on both sides (optax.sgd(1.0) patched in for JAX's Adam, as
`test_torch_vae_gan.py` does), so the updated weights are the gradients;
metrics and weights agree at rtol 1e-5, the weights with atol 1e-5 of each
tensor's largest update. JAX compiles each variant's two steps once; the
step count is traced, so the cases before and past disc_start (the
adaptive weights live) share them.
"""

import itertools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiolcm_torch.convert import (
    multi_window_from_jax,
    multi_window_to_jax,
    patchgan_from_jax,
    vae_from_jax,
)
from audiolcm_torch.models import discriminators as t_disc
from audiolcm_torch.models import lpaps as t_lpaps
from audiolcm_torch.models import multi_window_disc as t_mw
from audiolcm_torch.models.vae1d import AutoencoderKL1D as TorchVAE
from audiolcm_torch.models.vae1d import VAEConfig as TVAEConfig
from audiolcm_torch.train import vae_losses_extra as t_vle
from audiolcm_tpu.convert import convert_vae
from audiolcm_tpu.models import discriminators as j_disc
from audiolcm_tpu.models import lpaps as j_lpaps
from audiolcm_tpu.models import multi_window_disc as j_mw
from audiolcm_tpu.models.vae1d import AutoencoderKL1D as JaxVAE
from audiolcm_tpu.models.vae1d import DiagonalGaussian as JGaussian
from audiolcm_tpu.models.vae1d import VAEConfig as JVAEConfig
from audiolcm_tpu.train import vae_losses_extra as j_vle
from test_torch_vae_gan import CFG, NDF, NL, _assert_sd_close, _disc_to_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

B, T, M = 2, 32, 16
HIDDEN = 8
WINS = (16, 32)  # the variant steps' windows
STARTS = (21, 3)  # raw draws (before the clamp), one per window
TOL = dict(rtol=1e-5, atol=1e-5)


class pinned_draws:
    """Within the block, jax.random.randint returns `starts` in turn (one per
    kept window of each multi-window pass), and with dropout_off flax's
    Dropout is the identity."""

    def __init__(self, starts, dropout_off: bool = False):
        self.starts, self.dropout_off = starts, dropout_off

    def __enter__(self):
        cycle = itertools.cycle(self.starts)
        self.saved = jax.random.randint, flax_nn.Dropout
        jax.random.randint = lambda *a, **k: jnp.asarray(next(cycle), jnp.int32)
        if self.dropout_off:
            flax_nn.Dropout = lambda **kw: (lambda h: h)

    def __exit__(self, *exc):
        jax.random.randint, flax_nn.Dropout = self.saved


def _random_stats_(module: torch.nn.Module, seed: int = 0) -> None:
    """Non-trivial BatchNorm running statistics, so eval mode reads them."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, t_disc.FlaxBatchNorm):
            m.running_mean.copy_(torch.rand(m.running_mean.shape, generator=g) - 0.5)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)


@pytest.mark.parametrize("norm,reduction", [(n, r) for n in ("bn", "in", "sn")
                                            for r in ("sum", "stack", "none")])
def test_multi_window_towers_match_jax(norm, reduction, monkeypatch):
    """Both towers (unconditional and conditional), eval and train mode, a
    batch whose last 5 frames are zero (x_len 27, so the 32 window's start
    is clamped to 0 and the 16 window's raw draw 21 to 11)."""
    wins = (8, 16) if norm != "in" else WINS
    torch.manual_seed(1)
    monkeypatch.setattr(t_mw, "_dropout2d", lambda h, p, generator: h)  # as flax's, below
    tw = t_mw.MultiWindowDiscriminatorWrapper(wins, M, cond_size=5, hidden_size=HIDDEN,
                                              norm_type=norm, reduction=reduction)
    _random_stats_(tw)
    jw = j_mw.MultiWindowDiscriminatorWrapper(wins, M, cond_size=5, hidden_size=HIDDEN,
                                              norm_type=norm, reduction=reduction)
    r = np.random.default_rng(2)
    x = r.standard_normal((B, T, M)).astype(np.float32)
    x[:, -5:] = 0.0
    cond = r.standard_normal((B, T, 5)).astype(np.float32)
    starts, starts_c = (21, 3), (7, 30)
    for train in (False, True):
        params, stats = multi_window_to_jax(tw.state_dict(), wins, M)
        variables = {"params": params, **({"batch_stats": stats} if stats else {})}
        with pinned_draws(starts + starts_c, dropout_off=True):
            want, upd = jw.apply(variables, jnp.asarray(x), cond=jnp.asarray(cond), train=train,
                                 rngs={"windows": jax.random.key(0)}, mutable=["batch_stats"])
        got = tw(torch.from_numpy(x), cond=torch.from_numpy(cond), starts=torch.tensor(starts),
                 starts_c=torch.tensor(starts_c), train=train)
        for k in ("y", "y_c"):
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                       err_msg=f"{k} train={train}", **TOL)
        assert len(got["h"]) == len(want["h"]) == 3 * len(wins)
        for h_t, h_j in zip(got["h"], want["h"]):
            np.testing.assert_allclose(h_t.detach().numpy(),
                                       np.asarray(h_j).transpose(0, 3, 1, 2), **TOL)
        if train and norm != "in":  # BatchNorm statistics, or the spectral norm's u and sigma
            _assert_sd_close(tw.state_dict(),
                             multi_window_from_jax(params, upd["batch_stats"], wins, M))


def test_multi_window_drops_oversized_window_and_draws_in_range():
    """A window longer than T is dropped (JAX's rule); a draw from the
    generator stays in [0, T) and the clip in the mel."""
    torch.manual_seed(0)
    tw = t_mw.MultiWindowDiscriminatorWrapper((16, 64), M, hidden_size=HIDDEN, norm_type="in",
                                              reduction="stack")
    jw = j_mw.MultiWindowDiscriminatorWrapper((16, 64), M, hidden_size=HIDDEN, norm_type="in",
                                              reduction="stack")
    x = np.random.default_rng(3).standard_normal((B, T, M)).astype(np.float32)
    sd = tw.state_dict()
    params, _ = multi_window_to_jax({k: v for k, v in sd.items() if "conv_layers.1." not in k},
                                    (16, 64), M)
    with pinned_draws((9,)):
        want = jw.apply({"params": params}, jnp.asarray(x), train=False,
                        rngs={"windows": jax.random.key(0)})
    got = tw(torch.from_numpy(x), starts=torch.tensor([9, 0]), train=False)
    assert got["y"].shape == (B, 1, 1) == want["y"].shape
    np.testing.assert_allclose(got["y"].detach().numpy(), np.asarray(want["y"]), **TOL)
    g = torch.Generator().manual_seed(4)
    starts = t_mw.draw_starts(1000, T, g)
    assert int(starts.min()) >= 0 and int(starts.max()) < T
    out = tw(torch.from_numpy(x), train=False, generator=g)
    assert out["y"].shape == (B, 1, 1) and torch.isfinite(out["y"]).all()
    all_long = t_mw.MultiWindowDiscriminatorWrapper((64,), M, hidden_size=HIDDEN)
    assert all_long(torch.from_numpy(x), train=False)["y"] is None


def test_dropout2d_drops_whole_channels():
    """Train mode drops whole channels at rate 0.25 and scales the rest by
    4/3; eval mode leaves them."""
    h = torch.ones(64, 32, 4, 5)
    out = t_mw._dropout2d(h, 0.25, torch.Generator().manual_seed(0))
    per_channel = out.reshape(64, 32, -1)
    assert torch.all(per_channel.amax(-1) == per_channel.amin(-1))
    kept = per_channel[..., 0]
    assert kept.unique().tolist() == [0.0, float(torch.tensor(4.0 / 3.0))]
    assert abs(float((kept == 0).float().mean()) - 0.25) < 0.03
    tower = t_mw.Discriminator2DFactory(16, M, hidden_size=HIDDEN, norm_type="sn")
    x = torch.randn(2, 1, 16, M)
    assert torch.equal(tower(x, train=False)[0], tower(x, train=False)[0])


def _lpaps_state_dict(seed: int) -> dict:
    torch.manual_seed(seed)
    model = t_lpaps.LPAPS(M)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.randn_like(p) * (0.1 if "lin" in name else p[0].numel() ** -0.5))
    return model.state_dict()


def test_lpaps_matches_jax():
    """LPAPS on (B, 1, F, T) mels against JAX's on (B, F, T, 1), the
    ScalingLayer from the state dict and from a mean/std table."""
    sd = _lpaps_state_dict(5)
    r = np.random.default_rng(6)
    sd["scaling_layer.shift"] = torch.from_numpy(r.uniform(-0.2, 0.2, (1, 1, M, 1)).astype(
        np.float32))
    sd["scaling_layer.scale"] = torch.from_numpy(r.uniform(0.5, 1.5, (1, 1, M, 1)).astype(
        np.float32))
    mean_std = np.stack([r.uniform(0.3, 0.7, M), r.uniform(0.1, 0.3, M)], 1).astype(np.float32)
    x = np.tanh(r.standard_normal((B, 1, M, T))).astype(np.float32)
    y = np.tanh(x + 0.3 * r.standard_normal(x.shape)).astype(np.float32)
    to_j = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))
    for ms in (None, mean_std):
        model = t_lpaps.load_lpaps(sd, ms)
        np_sd = {k: v.numpy() for k, v in sd.items()}
        want = j_lpaps.LPAPS().apply(j_lpaps.lpaps_params_from_torch(np_sd, ms), to_j(x), to_j(y))
        got = model(torch.from_numpy(x), torch.from_numpy(y))
        assert got.shape == (B, 1, 1, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(model(torch.from_numpy(x), torch.from_numpy(x)).abs().max()) < 1e-6
    with pytest.raises(KeyError):
        t_lpaps.load_lpaps({k: v for k, v in sd.items() if "lin0" not in k})


def test_sequence_mask_and_mel_lengths_match_jax():
    r = np.random.default_rng(8)
    mel = r.standard_normal((3, T, M)).astype(np.float32)
    mel[0, 20:] = -1.0
    mel[2, 5:] = -1.0
    got = t_vle.mel_lengths_from_pad(torch.from_numpy(mel), -1.0)
    want = j_vle.mel_lengths_from_pad(jnp.asarray(mel), -1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist()[0] == 20 and got.tolist()[2] == 5
    np.testing.assert_array_equal(t_vle.sequence_mask(got, T).numpy(),
                                  np.asarray(j_vle.sequence_mask(want, T)))


# ---------------------------------------------------------------------------
# the variant steps
# ---------------------------------------------------------------------------


def _towers(variant: str, seed: int = 3) -> dict:
    torch.manual_seed(seed)
    discs = {}
    if variant in ("dis", "mask", "vq"):
        discs["patch"] = t_disc.NLayerDiscriminator2D(1, NDF, NL)
    if variant in ("multiw", "dis"):
        discs["multi"] = t_mw.MultiWindowDiscriminatorWrapper(
            WINS, M, hidden_size=HIDDEN, norm_type="in" if variant == "dis" else "bn",
            reduction="stack")
    for d in discs.values():
        _random_stats_(d)
    return discs


@pytest.fixture(scope="module")
def vae_init():
    torch.manual_seed(0)
    vae = TorchVAE(TVAEConfig(**CFG))
    sd = {k: v.detach().numpy() for k, v in vae.state_dict().items()}
    return vae.state_dict(), convert_vae(sd, num_levels=2, num_res_blocks=1, down_layers=(0,),
                                         attn_layers=())


_JAX_STEPS: dict = {}


def _jax_steps(variant: str, perceptual: bool, monkeypatch):
    """JAX's jitted (gen_step, disc_step) for the variant, compiled once."""
    monkeypatch.setattr(optax, "adam", lambda *a, **k: optax.sgd(1.0))
    key = (variant, perceptual)
    if key in _JAX_STEPS:
        return _JAX_STEPS[key]
    vae = JaxVAE(JVAEConfig(**CFG))

    def vae_apply(params, x, r):
        post = JGaussian(vae.apply({"params": params}, x, method=JaxVAE.encode_moments))
        return vae.apply({"params": params}, post.sample(r), method=JaxVAE.decode), post

    patch = j_disc.NLayerDiscriminator2D(ndf=NDF, n_layers=NL)
    multi = j_mw.MultiWindowDiscriminatorWrapper(
        WINS, M, hidden_size=HIDDEN, norm_type="in" if variant == "dis" else "bn",
        reduction="stack")
    stats: dict = {}  # filled per case; read at trace time

    def patch_apply(p, x):
        return patch.apply({"params": p, "batch_stats": stats["patch"]}, x, False)

    def multi_apply(p, x, r):
        vs = {"params": p, **({"batch_stats": stats["multi"]} if stats.get("multi") else {})}
        return multi.apply(vs, x, train=False, rngs={"windows": r})["y"]

    perceptual_fn = None
    if perceptual:
        lp_sd = {k: v.numpy() for k, v in _lpaps_state_dict(9).items()}
        lp_vars = j_lpaps.lpaps_params_from_torch(lp_sd)
        # per-sample (B, 1, 1): added to the (B, T, F) L1 terms as the reference adds its
        # (B, 1, 1, 1) to (B, 1, F, T)
        perceptual_fn = lambda x, y: j_lpaps.LPAPS().apply(
            lp_vars, jnp.swapaxes(x, 1, 2)[..., None], jnp.swapaxes(y, 1, 2)[..., None]
        ).reshape(-1, 1, 1)
    cfg = j_vle.VariantConfig(variant=variant, disc_start=5, perceptual_weight=0.5 * perceptual)
    gen, disc = j_vle.make_variant_gan_steps(
        vae_apply, cfg, patch_disc_apply=patch_apply, multi_disc_apply=multi_apply,
        last_layer_get=lambda p: p["decoder"]["conv_out"]["kernel"],
        last_layer_set=lambda p, v: {**p, "decoder": {**p["decoder"], "conv_out": {
            **p["decoder"]["conv_out"], "kernel": v}}},
        perceptual_fn=perceptual_fn)
    _JAX_STEPS[key] = (jax.jit(gen), jax.jit(disc), stats, cfg)
    return _JAX_STEPS[key]


@pytest.mark.parametrize("variant,step0", [(v, s) for v in ("multiw", "dis") for s in (0, 5)])
def test_variant_steps_match_jax(vae_init, monkeypatch, variant, step0):
    """The multi-window variants (the patch-only ones and LPAPS:
    `test_torch_loss_variant_steps.py`)."""
    check_variant_step(vae_init, monkeypatch, variant, step0, perceptual=False)


def check_variant_step(vae_init, monkeypatch, variant, step0, perceptual):
    """One generator + one discriminator step from step0 with disc_start 5:
    at 0 the adversarial terms are gated off (factor 0), at 5 both towers'
    adaptive weights are live. The mask variant's mel has padded frames
    (pad_value -1); the vq cases pass a codebook loss, and one of them
    adds LPAPS at perceptual_weight 0.5."""
    gen_j, disc_j, stats, jcfg = _jax_steps(variant, perceptual, monkeypatch)
    discs = _towers(variant)
    dparams = {}
    if "patch" in discs:
        dparams["patch"], stats["patch"] = _disc_to_jax(discs["patch"])
    if "multi" in discs:
        dparams["multi"], stats["multi"] = multi_window_to_jax(discs["multi"].state_dict(),
                                                               WINS, M)
    ae = vae_init[1]
    state_j = j_vle.init_variant_state(ae, dparams, jcfg)._replace(
        step=jnp.asarray(step0, jnp.int32))
    r = np.random.default_rng(11)
    mel = (r.standard_normal((B, T, M)) * 0.5).astype(np.float32)
    if variant == "mask":
        mel[0, 24:] = -1.0
        mel[1, 12:] = -1.0
    key = jax.random.PRNGKey(4)
    codebook = jnp.asarray([0.25, 0.5], jnp.float32)
    with pinned_draws(STARTS):
        if variant == "vq":
            state_j, gm_j = gen_j(state_j, jnp.asarray(mel), key, codebook)
        else:
            state_j, gm_j = gen_j(state_j, jnp.asarray(mel), key)
        state_j, dm_j = disc_j(state_j, jnp.asarray(mel), key)
    rng_vae = jax.random.split(key)[0]
    noise = torch.from_numpy(np.array(jax.random.normal(rng_vae, (B, T // 2, CFG["embed_dim"]))))

    cfg = t_vle.VariantConfig(variant=variant, disc_start=5, perceptual_weight=0.5 * perceptual)
    vae = TorchVAE(TVAEConfig(**CFG))
    vae.load_state_dict(vae_init[0])
    before = {**{"vae." + k: v.clone() for k, v in vae.state_dict().items()},
              **{"discs." + k: v.clone()
                 for k, v in torch.nn.ModuleDict(discs).state_dict().items()}}
    state = t_vle.init_variant_state(vae, discs, cfg,
                                     optimizer=lambda p: torch.optim.SGD(p, lr=1.0))
    state.step = step0
    lp = t_lpaps.lpaps_perceptual(t_lpaps.load_lpaps(_lpaps_state_dict(9), n_freq=M))
    gen, disc, _ = t_vle.make_variant_gan_steps(cfg, perceptual_fn=lp if perceptual else None)
    starts = torch.tensor(STARTS) if "multi" in discs else None
    draws = t_vle.Draws(noise, starts)
    state, gm = gen(state, torch.from_numpy(mel), draws,
                    codebook_loss=torch.tensor([0.25, 0.5]) if variant == "vq" else None)
    state, dm = disc(state, torch.from_numpy(mel), draws)
    assert state.step == int(state_j.step) == step0 + 1
    assert set(gm) == set(gm_j) and set(dm) == set(dm_j)
    for k, v in {**gm_j, **dm_j}.items():
        np.testing.assert_allclose(float({**gm, **dm}[k]), float(v), err_msg=k, **TOL)
    if step0:
        assert all(float(gm[k]) > 0 for k in gm if "d_weight" in k)
        assert float(dm["train/disc_loss_total"]) != 0
    _assert_sd_close(state.vae.state_dict(), vae_from_jax(state_j.ae_params),
                     {k[4:]: v for k, v in before.items() if k.startswith("vae.")})
    want = {}
    if "patch" in discs:
        want.update({"patch." + k: v for k, v in patchgan_from_jax(
            state_j.disc_params["patch"], stats["patch"]).items()})
    if "multi" in discs:
        want.update({"multi." + k: v for k, v in multi_window_from_jax(
            state_j.disc_params["multi"], stats["multi"], WINS, M).items()})
    _assert_sd_close(state.discs.state_dict(), want,
                     {k[6:]: v for k, v in before.items() if k.startswith("discs.")})


def test_step_draws_once_per_training_step():
    """step() draws the posterior noise and the window starts once and
    hands the same draws to both steps: a generator in the same state gives
    the same metrics as explicit draws taken from it in that order."""
    torch.manual_seed(0)
    cfg = t_vle.VariantConfig(variant="dis", disc_start=0)
    metrics = []
    for explicit in (False, True):
        vae = TorchVAE(TVAEConfig(**CFG))
        state = t_vle.init_variant_state(vae, _towers("dis"), cfg)
        _, _, step = t_vle.make_variant_gan_steps(cfg)
        mel = torch.from_numpy(np.random.default_rng(1).standard_normal((B, T, M)).astype(
            np.float32))
        g = torch.Generator().manual_seed(7)
        if explicit:
            starts = t_mw.draw_starts(len(WINS), T, g)  # the starts first, then the noise
            noise = torch.randn(B, T // 2, CFG["embed_dim"], generator=g)
            _, m = step(state, mel, noise=noise, starts=starts)
        else:
            _, m = step(state, mel, g)
        metrics.append({k: float(v) for k, v in m.items()})
        torch.manual_seed(0)
    assert metrics[0] == metrics[1]
    with pytest.raises(ValueError, match="variant"):
        t_vle.make_variant_gan_steps(t_vle.VariantConfig(variant="nope"))
