"""Port parity: the VAE-GAN trainer (`audiolcm_torch/train/vae_gan.py`) and
the PatchGAN discriminators (`models/discriminators.py`) against
audiolcm_tpu, f32 on the CPU, at tiny widths (mel 16 x 32 frames, VAE ch 32
with ch_mult (1, 2), discriminator ndf 8 with 2 strided layers).

Weights start from one random port init, carried to JAX by its own
`convert_vae` and to the discriminator's flax tree by the inverse of
`convert.patchgan_from_jax`, which the results come back through. The
steps run with the same posterior noise and plain SGD at lr 1 on both
sides (optax.sgd(1.0) patched in for JAX's Adam), so the updated weights
are the old ones minus the gradients; they, the BatchNorm running
statistics and the metrics agree at rtol 1e-5, the weights with atol 1e-5
of each tensor's largest update (the L1 reconstruction sum gives updates
of O(10); f32 sums of 10^3 such terms round at ~1e-5 of them). JAX's steps
are compiled once per loss kind, and the adversarial term is switched on
by the step count (disc_start 80001, states at step 0 and 80001), so one
compiled generator step serves every case. The Adam pair agrees with
optax's on identical gradients at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiolcm_torch.convert import assign_state_dict, patchgan_from_jax, vae_from_jax
from audiolcm_tpu.convert import convert_vae
from audiolcm_torch.models import discriminators as t_disc
from audiolcm_torch.models.vae1d import AutoencoderKL1D as TorchVAE
from audiolcm_torch.models.vae1d import VAEConfig as TVAEConfig
from audiolcm_torch.train import vae_gan as t_vg
from audiolcm_tpu.models import discriminators as j_disc
from audiolcm_tpu.models.vae1d import AutoencoderKL1D as JaxVAE
from audiolcm_tpu.models.vae1d import DiagonalGaussian as JGaussian
from audiolcm_tpu.models.vae1d import VAEConfig as JVAEConfig
from audiolcm_tpu.train import vae_gan as j_vg
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

CFG = dict(in_channels=16, out_ch=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
           attn_layers=(), down_layers=(0,), kernel_size=5, z_channels=4, embed_dim=4)
B, T, M = 2, 32, 16
NDF, NL = 8, 2


def _disc_to_jax(disc) -> tuple:
    """The port discriminator's weights and running stats as JAX's
    NLayerDiscriminator2D trees (the inverse of patchgan_from_jax)."""
    sd = {k: v.detach().numpy() for k, v in disc.state_dict().items()}
    names = ["conv_0"] + [f"conv_{n}" for n in range(1, NL + 1)]
    params, stats = {}, {}
    for i, name in enumerate(names):
        idx = 0 if i == 0 else 3 * i - 1
        params[name] = {"kernel": sd[f"main.{idx}.weight"].transpose(2, 3, 1, 0)}
        if f"main.{idx}.bias" in sd:
            params[name]["bias"] = sd[f"main.{idx}.bias"]
        if i:
            n = f"main.{idx + 1}"
            params[f"bn_{i}"] = {"scale": sd[f"{n}.weight"], "bias": sd[f"{n}.bias"]}
            stats[f"bn_{i}"] = {"mean": sd[f"{n}.running_mean"], "var": sd[f"{n}.running_var"]}
    idx = 3 * NL + 2
    params["conv_out"] = {"kernel": sd[f"main.{idx}.weight"].transpose(2, 3, 1, 0),
                          "bias": sd[f"main.{idx}.bias"]}
    return params, stats


@pytest.fixture(scope="module")
def init():
    """Port modules from a seed (non-trivial running statistics, so eval
    mode reads them) and their JAX trees."""
    torch.manual_seed(0)
    vae = TorchVAE(TVAEConfig(**CFG))
    disc = t_disc.NLayerDiscriminator2D(1, NDF, NL)
    for m in disc.modules():
        if isinstance(m, t_disc.FlaxBatchNorm):
            m.running_mean.uniform_(-0.5, 0.5)
            m.running_var.uniform_(0.5, 1.5)
    sd = {k: v.detach().numpy() for k, v in vae.state_dict().items()}
    ae = convert_vae(sd, num_levels=2, num_res_blocks=1, down_layers=(0,), attn_layers=())
    dparams, stats = _disc_to_jax(disc)
    return vae.state_dict(), disc.state_dict(), ae, dparams, stats


def _port_modules(init):
    vae = TorchVAE(TVAEConfig(**CFG))
    vae.load_state_dict(init[0])
    disc = t_disc.NLayerDiscriminator2D(1, NDF, NL)
    disc.load_state_dict(init[1])
    return vae, disc


def _assert_sd_close(got: dict, want: dict, before: dict = None):
    """rtol 1e-5; atol 1e-5 of the tensor's largest update (1e-5 without one)."""
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        scale = 1.0 if before is None else max(1.0, float((v - before[k]).abs().max()))
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), err_msg=k, rtol=1e-5,
                                   atol=1e-5 * scale)


def test_discriminator_train_and_eval_match_jax(init, rng):
    """Train-mode logits and the running statistics it leaves (flax's
    momentum 0.9 and biased variance), eval-mode logits on the running
    statistics, and the train pass that keeps them (`update_stats=False`)."""
    _, _, _, dparams, stats = init
    disc_j = j_disc.NLayerDiscriminator2D(ndf=NDF, n_layers=NL)
    _, disc = _port_modules(init)
    x = rng.standard_normal((3, M, T, 1)).astype(np.float32) * 2 + 0.5
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    want, upd = disc_j.apply({"params": dparams, "batch_stats": stats}, jnp.asarray(x), True,
                             mutable=["batch_stats"])
    want_eval = disc_j.apply({"params": dparams, "batch_stats": stats}, jnp.asarray(x), False)
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    kept = disc(xt, train=True, update_stats=False)
    assert all(torch.equal(before[k], v) for k, v in disc.state_dict().items())
    got = disc(xt, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(kept, got)
    _assert_sd_close(disc.state_dict(), patchgan_from_jax(dparams, upd["batch_stats"]))
    disc.load_state_dict(before)
    np.testing.assert_allclose(disc(xt, train=False).detach().numpy(),
                               np.asarray(want_eval).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)


_JAX_STEPS: dict = {}


def _jax_steps(kind, monkeypatch):
    """JAX's (gen_step, disc_step), compiled; one generator step for all
    kinds (it does not read disc_loss)."""
    monkeypatch.setattr(j_vg, "make_optimizers", lambda c: (optax.sgd(1.0), optax.sgd(1.0)))
    if kind not in _JAX_STEPS:
        vae, disc = JaxVAE(JVAEConfig(**CFG)), j_disc.NLayerDiscriminator2D(ndf=NDF, n_layers=NL)

        def vae_apply(params, x, r):
            moments = vae.apply({"params": params}, x, method=JaxVAE.encode_moments)
            post = JGaussian(moments)
            return vae.apply({"params": params}, post.sample(r), method=JaxVAE.decode), post

        def disc_apply(params, st, x, train):
            if train:
                logits, u = disc.apply({"params": params, "batch_stats": st}, x, True,
                                       mutable=["batch_stats"])
                return logits, u["batch_stats"]
            return disc.apply({"params": params, "batch_stats": st}, x, False), st

        gen, dstep = j_vg.make_vae_gan_steps(vae_apply, disc_apply,
                                             j_vg.VAEGANConfig(disc_loss=kind))
        shared = next(iter(_JAX_STEPS.values()))[0] if _JAX_STEPS else jax.jit(gen)
        _JAX_STEPS[kind] = (shared, jax.jit(dstep))
    return _JAX_STEPS[kind]


@pytest.mark.parametrize("disc_loss", ["mse", "hinge", "vanilla"])
@pytest.mark.parametrize("step0", [80001, 0])
def test_gen_and_disc_steps_match_jax(init, monkeypatch, step0, disc_loss):
    """One generator and one discriminator step (SGD lr 1, one noise draw
    for both, as the trainers pass one key) at disc_start 80001 from step
    80001 (the adversarial term, the adaptive weight and R1 live) and from
    step 0 (only R1 and the reconstruction terms): the metrics, the updated
    VAE and discriminator and the running statistics, which only the fake
    pass advances."""
    gen_j, disc_j = _jax_steps(disc_loss, monkeypatch)
    ae, dparams, stats = init[2:]
    state_j = j_vg.init_vae_gan_state(ae, dparams, stats, j_vg.VAEGANConfig())
    state_j = state_j._replace(step=jnp.asarray(step0, jnp.int32))
    r = np.random.default_rng(7)
    mel = (r.standard_normal((B, T, M)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(3)
    state_j, gm_j = gen_j(state_j, jnp.asarray(mel), key)
    state_j, dm_j = disc_j(state_j, jnp.asarray(mel), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (B, T // 2, CFG["embed_dim"]))))

    tcfg = t_vg.VAEGANConfig(disc_loss=disc_loss)
    state = t_vg.init_vae_gan_state(*_port_modules(init), tcfg,
                                    optimizer=lambda p: torch.optim.SGD(p, lr=1.0))
    state.step = step0
    _, _, step = t_vg.make_vae_gan_steps(tcfg)
    state, m = step(state, torch.from_numpy(mel), noise=noise)
    assert state.step == int(state_j.step) == step0 + 1
    for k, v in {**gm_j, **dm_j}.items():
        np.testing.assert_allclose(float(m[k]), float(v), err_msg=k, rtol=1e-5, atol=1e-5)
    assert float(m["train/r1_penalty"]) > 0 and float(m["train/d_weight"]) > 0
    if step0:
        assert float(m["train/g_loss"]) != 0
    _assert_sd_close(state.vae.state_dict(), vae_from_jax(state_j.ae_params), init[0])
    _assert_sd_close(state.disc.state_dict(),
                     patchgan_from_jax(state_j.disc_params, state_j.disc_batch_stats), init[1])


def test_adam_pair_matches_optax(rng):
    """Adam(lr, betas 0.5, 0.9) against optax.adam on identical gradients,
    3 steps."""
    cfg = t_vg.VAEGANConfig(learning_rate=1e-2)
    init = rng.standard_normal((5, 3)).astype(np.float32)
    tx = j_vg.make_optimizers(j_vg.VAEGANConfig(learning_rate=1e-2))[0]
    pj = jnp.asarray(init)
    st = tx.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(init.copy()))
    opt = t_vg.make_optimizer(cfg, [pt])
    for scale in (3.0, 0.1, 1.0):
        g = (rng.standard_normal(init.shape) * scale).astype(np.float32)
        u, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, u)
        pt.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), atol=1e-6)


def test_disc_loss_kinds_and_adopt_weight():
    lr_, lf = torch.tensor([0.3, -1.2, 2.0]), torch.tensor([0.5, -0.1, 1.5])
    for kind in ("mse", "hinge", "vanilla"):
        np.testing.assert_allclose(float(t_vg.disc_loss_fn(kind, lr_, lf)), float(
            j_vg.disc_loss_fn(kind, jnp.asarray(lr_.numpy()), jnp.asarray(lf.numpy()))),
            rtol=1e-6)
    with pytest.raises(ValueError):
        t_vg.disc_loss_fn("nope", lr_, lf)
    assert t_vg.adopt_weight(2.0, 4, 5) == 0.0 and t_vg.adopt_weight(2.0, 5, 5) == 2.0


@pytest.mark.parametrize("kind", ["feats_bn", "specs_actnorm"])
def test_1d_discriminators_match_jax(rng, kind):
    """The loss variants' 1D discriminators: train-mode logits (BatchNorm
    with its running statistics, or ActNorm initialised from the batch)."""
    c = 32 if kind == "feats_bn" else 16
    if kind == "feats_bn":
        jm, tm = j_disc.NLayerDiscriminator1dFeats(c), t_disc.NLayerDiscriminator1dFeats(c)
    else:
        jm = j_disc.NLayerDiscriminator1dSpecs(c, ndf=8, use_actnorm=True)
        tm = t_disc.NLayerDiscriminator1dSpecs(c, ndf=8, use_actnorm=True)
    x = rng.standard_normal((2, 48, c)).astype(np.float32)
    v = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    params = jax.tree.map(np.asarray, v["params"])
    assign_state_dict(tm, patchgan_from_jax(params, v.get("batch_stats")))
    if kind == "specs_actnorm":
        for layer in tm.main:
            if isinstance(layer, t_disc.ActNorm):
                layer.initialized.fill_(0)
        xt = torch.from_numpy(x.transpose(0, 2, 1).copy())
        tm(xt)  # data-dependent init, then hand the values to JAX
        sd = tm.state_dict()
        i = 3
        for name in ["norm_1", "norm_2", "norm_3"]:
            params[name] = {"loc": sd[f"main.{i}.loc"].reshape(-1).numpy(),
                            "scale": sd[f"main.{i}.scale"].reshape(-1).numpy()}
            i += 3
        want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
        got = tm(xt)
    else:
        want, _ = jax.jit(lambda v_, x_: jm.apply(v_, x_, True, mutable=["batch_stats"]))(
            v, jnp.asarray(x))
        got = tm(torch.from_numpy(x.transpose(0, 2, 1).copy()), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want).transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-5)
