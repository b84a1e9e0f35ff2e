"""Port parity: the auxiliary LDM trainers (audiolcm_torch.train.
ldm_variants) against audiolcm_tpu.train.ldm_variants, and the config
registry against audiolcm_tpu.config.MODEL_REGISTRY, f32 on the CPU.

The steps run on the JAX side with its own draws (split(rng) -> randint /
normal), recomputed and injected into the port: under SGD lr 1 against
optax.sgd(1.0), then under the shipped optimisers (the teacher's clip +
AdamW chain, the classifier's AdamW). Parameters come from a numpy seed.
Tolerances are tests/test_torch_train.py's: metrics at rtol 1e-5, the
updated parameters at atol 1e-5. The training CLI trains a ConcatDiT and a
TxtFlagLargeDiT teacher, as the JAX CLI does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiolcm_torch import config as t_cfg
from audiolcm_torch.convert import assign_state_dict, dit_from_jax
from audiolcm_torch.diffusion.schedule import NoiseSchedule as TSchedule
from audiolcm_torch.models.dit import ConcatDiT2MLP as TDiT
from audiolcm_torch.models.order_dit import ConcatOrderDiT as TOrderDiT
from audiolcm_torch.models.order_dit import compute_order_indices
from audiolcm_torch.train import ldm_variants as t_ldm
from audiolcm_torch.train import teacher as t_teacher
from audiolcm_tpu import config as j_cfg
from audiolcm_tpu.diffusion.schedule import NoiseSchedule as JSchedule
from audiolcm_tpu.models.dit import ConcatDiT2MLP as JDiT
from audiolcm_tpu.models.order_dit import ConcatOrderDiT as JOrderDiT
from audiolcm_tpu.train import ldm_variants as j_ldm
from audiolcm_tpu.train import teacher as j_teacher
from tests.test_torch_text import random_params
from tests.test_torch_train_cli import StubTokenizers, _diffusion_cfg, _manifest, _run, _val
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

Z, CTX, HIDDEN, HEADS, MAX_LEN = 4, 8, 32, 4, 64
B, T, LC = 2, 8, 3
ATOL = 1e-5
OPTIMIZERS = ["sgd", "adamw"]


def _schedules():
    return JSchedule.linear(20, 0.0015, 0.0195), TSchedule.linear(20, 0.0015, 0.0195)


def _draws(key, shape, num_timesteps=20):
    r_t, r_noise = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.randint(r_t, (shape[0],), 0, num_timesteps))),
            torch.from_numpy(np.array(jax.random.normal(r_noise, shape))))


def _tree_close(model: torch.nn.Module, jax_sd: dict, opt: str) -> None:
    """The port's updated parameters against JAX's at ATOL. After the first
    AdamW step an element moves by lr g / (|g| + 1e-8), whose derivative in
    g is lr 1e-8 / g^2: where 0 < |g| < 1e-6 (the clipped gradient, still
    in .grad) it amplifies the f32 rounding of g past ATOL, so those
    elements (0.5-0.7 % of these models; at most 2 %) are left out. The
    SGD case holds every element."""
    skipped = total = 0
    for k, v in jax_sd.items():
        p = model.get_parameter(k)
        g = p.grad.abs()
        keep = (g >= 1e-6) | (g == 0) if opt == "adamw" else torch.ones_like(p, dtype=bool)
        skipped, total = skipped + int((~keep).sum()), total + p.numel()
        np.testing.assert_allclose(p.detach()[keep].numpy(), v[keep].numpy(), atol=ATOL,
                                   err_msg=k)
    assert skipped < 0.02 * total


def _teacher_cfgs(opt: str):
    """The JAX and port teacher configs and optimiser factories: SGD lr 1,
    or the clip + AdamW chain at a constant 1e-2."""
    if opt == "sgd":
        return (j_teacher.TeacherConfig(), optax.sgd(1.0), t_teacher.TeacherConfig(),
                lambda p: torch.optim.SGD(p, lr=1.0))
    lr = lambda step: 1e-2
    return (j_teacher.TeacherConfig(lr_schedule=lr), None,
            t_teacher.TeacherConfig(lr_schedule=lr), None)


def _run_steps(jm, jargs, params, tmodel, targs, make_j, make_t, opt, apply_j, apply_t, z):
    jcfg, jopt, tcfg, topt = _teacher_cfgs(opt)
    jopt_ = jopt or j_teacher.make_teacher_optimizer(jcfg)
    state_j = j_teacher.TeacherState(jnp.zeros((), jnp.int32), params, jopt_.init(params))
    step_j = make_j(apply_j, _schedules()[0], jcfg, jopt_)
    key = jax.random.PRNGKey(5)
    state_j, m_j = jax.jit(step_j)(state_j, jnp.asarray(z), *jargs, key)
    t, noise = _draws(key, z.shape)
    state = t_teacher.init_teacher_state(tmodel, tcfg, optimizer=topt)
    state, m = make_t(apply_t, _schedules()[1], tcfg)(state, torch.from_numpy(z), *targs,
                                                       t=t, noise=noise)
    for k in ("train/loss_simple", "train/loss"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5, atol=ATOL)
    assert state.step == 1
    return state, state_j


@pytest.mark.parametrize("src,dst", [(624, 312), (1000, 312), (7, 3)])
def test_resize_mask_matches_jax(src, dst):
    mask = (np.random.default_rng(src).random((2, 1, src)) > 0.5).astype(np.float32)
    got = t_ldm.resize_mask_nearest(torch.from_numpy(mask), dst)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_ldm.resize_mask_nearest(jnp.asarray(mask), dst)))
    got2 = t_ldm.resize_mask_nearest(torch.from_numpy(mask[:, 0]), dst)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())
    latent = np.random.default_rng(1).standard_normal((2, Z, dst)).astype(np.float32)
    np.testing.assert_array_equal(
        t_ldm.build_inpaint_cond(torch.from_numpy(latent), torch.from_numpy(mask)).numpy(),
        np.asarray(j_ldm.build_inpaint_cond(jnp.asarray(latent), jnp.asarray(mask))))


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_inpaint_step_matches_jax(opt):
    """ConcatDiT2MLP with in = 2 Z + 1 channels and out = Z, channels-first
    latents; the eps-MSE over the z channels."""
    rng = np.random.default_rng(2)
    z = rng.standard_normal((B, Z, T)).astype(np.float32)
    c_concat = rng.standard_normal((B, Z + 1, T)).astype(np.float32)
    ctx = rng.standard_normal((B, 2 * LC, CTX)).astype(np.float32)
    kw = dict(in_channels=2 * Z + 1, context_dim=CTX, hidden_size=HIDDEN, depth=1,
              num_heads=HEADS, max_len=MAX_LEN, out_channels=Z)
    jm = JDiT(**kw)
    params = random_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((B, T, 2 * Z + 1)), jnp.zeros((B,), jnp.int32),
        jnp.asarray(ctx), jnp.zeros((B, 256))))["params"], 3)
    apply_j = lambda p, x, t, c: jnp.swapaxes(jm.apply({"params": p}, jnp.swapaxes(x, 1, 2),
                                                       t, c), 1, 2)
    apply_t = lambda m, x, t, c: m(x.transpose(1, 2), t, c).transpose(1, 2)
    state, state_j = _run_steps(
        jm, [jnp.asarray(c_concat), jnp.asarray(ctx)], params,
        assign_state_dict(TDiT(**kw), dit_from_jax(params)),
        [torch.from_numpy(c_concat), torch.from_numpy(ctx)],
        j_ldm.make_inpaint_step, t_ldm.make_inpaint_step, opt, apply_j, apply_t, z)
    _tree_close(state.model, dit_from_jax(jax.tree.map(np.asarray, state_j.params)), opt)


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_order_step_matches_jax(opt):
    rng = np.random.default_rng(4)
    z = rng.standard_normal((B, Z, T)).astype(np.float32)
    tok = rng.standard_normal((B, 6, CTX)).astype(np.float32)
    ids = np.array([[101, 5, 6, 1064, 7, 102], [101, 8, 1064, 9, 1064, 10]])
    order = compute_order_indices(ids, [[3], [1, 4, 2]])
    kw = dict(in_channels=Z, context_dim=CTX, hidden_size=HIDDEN, depth=1, num_heads=HEADS,
              max_len=MAX_LEN)
    jm = JOrderDiT(**kw)
    params = random_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((B, T, Z)), jnp.zeros((B,), jnp.int32),
        jnp.asarray(tok), jnp.asarray(order), jnp.zeros((B, 256))))["params"], 5)
    apply_j = lambda p, x, t, e, o: jnp.swapaxes(jm.apply({"params": p}, jnp.swapaxes(x, 1, 2),
                                                          t, e, o), 1, 2)
    apply_t = lambda m, x, t, e, o: m(x.transpose(1, 2), t, e, o).transpose(1, 2)
    state, state_j = _run_steps(
        jm, [jnp.asarray(tok), jnp.asarray(order)], params,
        assign_state_dict(TOrderDiT(**kw), dit_from_jax(params)),
        [torch.from_numpy(tok), torch.from_numpy(order)],
        j_ldm.make_order_step, t_ldm.make_order_step, opt, apply_j, apply_t, z)
    _tree_close(state.model, dit_from_jax(jax.tree.map(np.asarray, state_j.params)), opt)


K_CLASSES = 7


def _classifier(seed: int):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((Z, K_CLASSES)) * 0.5).astype(np.float32),
              "b": (rng.standard_normal(K_CLASSES) * 0.1).astype(np.float32)}
    head = torch.nn.Linear(Z, K_CLASSES)
    head.load_state_dict({"weight": torch.from_numpy(params["w"].T.copy()),
                          "bias": torch.from_numpy(params["b"])})
    return params, head


def _apply_j(p, x, t):
    return jnp.mean(x, axis=-1) @ p["w"] + p["b"]


def _apply_t(m, x, t):
    return m(x.mean(-1))


@pytest.mark.parametrize("opt,t_fixed", [("sgd", -1), ("adamw", -1), ("adamw", 7)])
def test_classifier_step_matches_jax(monkeypatch, opt, t_fixed):
    """A linear head over the time-pooled latent; loss, acc@1, acc@5 and the
    update. Under "sgd" JAX's classifier optimiser is patched to
    optax.sgd(1.0) (its step builds it)."""
    rng = np.random.default_rng(6)
    z = rng.standard_normal((8, Z, T)).astype(np.float32)
    targets = rng.integers(0, K_CLASSES, (8,))
    params, head = _classifier(7)
    cfg_j, cfg_t = j_ldm.ClassifierConfig(K_CLASSES, 1e-2), t_ldm.ClassifierConfig(K_CLASSES, 1e-2)
    topt = None
    if opt == "sgd":
        monkeypatch.setattr(j_ldm, "make_classifier_optimizer", lambda cfg: optax.sgd(1.0))
        topt = lambda p: torch.optim.SGD(p, lr=1.0)
    jparams = jax.tree.map(jnp.asarray, params)
    state_j = j_ldm.ClassifierState(jnp.zeros((), jnp.int32), jparams,
                                    j_ldm.make_classifier_optimizer(cfg_j).init(jparams))
    key = jax.random.PRNGKey(8)
    state_j, m_j = j_ldm.make_classifier_step(_apply_j, _schedules()[0], cfg_j)(
        state_j, jnp.asarray(z), jnp.asarray(targets), key, t_fixed)
    t, noise = _draws(key, z.shape)
    state = t_ldm.init_classifier_state(head, cfg_t, optimizer=topt)
    state, m = t_ldm.make_classifier_step(_apply_t, _schedules()[1], cfg_t)(
        state, torch.from_numpy(z), torch.from_numpy(targets), t_fixed=t_fixed,
        t=None if t_fixed >= 0 else t, noise=noise)
    for k in ("train/loss", "train/acc@1", "train/acc@5"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(head.weight.detach().numpy().T, np.asarray(state_j.params["w"]),
                               atol=ATOL)
    np.testing.assert_allclose(head.bias.detach().numpy(), np.asarray(state_j.params["b"]),
                               atol=ATOL)
    assert np.abs(head.weight.detach().numpy().T - params["w"]).max() > 1e-3


def test_top_k_accuracy_and_sweep_match_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (6,))
    for k in (1, 5):
        assert float(t_ldm.top_k_accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                                          k)) == pytest.approx(float(j_ldm.top_k_accuracy(
                                              jnp.asarray(logits), jnp.asarray(labels), k)))
    z = rng.standard_normal((8, Z, T)).astype(np.float32)
    targets = rng.integers(0, K_CLASSES, (8,))
    params, head = _classifier(10)
    key = jax.random.PRNGKey(11)
    want = j_ldm.noisy_accuracy_sweep(_apply_j, jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(z), jnp.asarray(targets), _schedules()[0],
                                      key, log_every_t=6)
    noises, rng_j = [], key
    for _ in range(0, 20, 6):
        rng_j, r = jax.random.split(rng_j)
        noises.append(torch.from_numpy(np.array(jax.random.normal(r, z.shape))))
    got = t_ldm.noisy_accuracy_sweep(_apply_t, head, torch.from_numpy(z),
                                     torch.from_numpy(targets), _schedules()[1], log_every_t=6,
                                     noises=noises)
    assert sorted(got) == sorted(want) == [0, 6, 12, 18]
    for t_val, accs in want.items():
        assert got[t_val] == pytest.approx(accs)


DIT_PARAMS = {"in_channels": 4, "context_dim": 8, "hidden_size": 32, "depth": 1, "num_heads": 4,
              "max_len": 64}
BERT = {"vocab_size": 30, "hidden_size": 16, "num_layers": 1, "num_heads": 2,
        "intermediate_size": 32, "max_position_embeddings": 16}
T5 = {"vocab_size": 30, "d_model": 16, "d_kv": 8, "d_ff": 24, "num_layers": 1, "num_heads": 2}
DD = {"double_z": True, "in_channels": 8, "out_ch": 8, "z_channels": 4, "ch": 32,
      "ch_mult": [1, 2], "num_res_blocks": 1}


def _registry_params(target: str) -> dict:
    if "LAION" in target:
        return {}
    if "diffusionmodules" in target:
        extra = ({"n_kv_heads": 2, "qk_norm": True, "multiple_of": 16}
                 if target.endswith("TxtFlagLargeDiT") else
                 {"out_channels": 2} if target.endswith("ConcatDiT2MLP") else {})
        return dict(DIT_PARAMS, **extra)
    if target.endswith("autoencoder1d.AutoencoderKL"):
        return {"embed_dim": 4, "ddconfig": dict(DD, kernel_size=5, down_layers=[0])}
    if target.endswith("autoencoder.AutoencoderKL"):
        return {"embed_dim": 4, "ddconfig": dict(DD, in_channels=1, out_ch=1, resolution=16,
                                                 attn_resolutions=[8])}
    return {"bert_config": BERT, "t5_config": T5, "d_proj": 16}


def _leaves(tree) -> int:
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))


def test_registry_builds_every_jax_target():
    """Every key of JAX's MODEL_REGISTRY builds the same class with the same
    parameter count; the two LAION CLAP embedders at their published widths
    (HTSAT-tiny + roberta-base, the audio side dropped), counted against
    JAX's tree as a checkpoint loads it (the tower, the text projection and
    transform, the logit scales)."""
    laion = [k for k in j_cfg.MODEL_REGISTRY if "LAION" in k]
    assert len(laion) == 2 and len(j_cfg.MODEL_REGISTRY) == 13
    for target in j_cfg.MODEL_REGISTRY:
        node = {"target": target, "params": _registry_params(target)}
        if target in laion:
            port, ref = t_cfg.build_from_target(node), j_cfg.build_from_target(node)
            assert type(port).__name__ == type(ref).__name__, target
            ids = jnp.zeros((1, 5), jnp.int32)
            n = _leaves(jax.eval_shape(lambda: ref.model.init(
                jax.random.PRNGKey(0), ids, jnp.ones_like(ids),
                method=lambda m, i, a: m.text_transform(m.encode_text(i, a))))["params"])
            assert sum(p.numel() for p in port.parameters()) == n, target
            continue
        port, ref = t_cfg.build_from_target(node), j_cfg.build_from_target(node)
        if isinstance(ref, dict):  # text conditioners: towers by name
            assert set(port) == set(ref), target
            for name in ("clap_text", "t5"):
                assert (port[name] is None) == (ref[name] is None), (target, name)
                if ref[name] is not None:
                    ids = jnp.zeros((1, 5), jnp.int32)
                    n = _leaves(jax.eval_shape(lambda: ref[name].init(
                        jax.random.PRNGKey(0), ids))["params"])
                    assert sum(p.numel() for p in port[name].parameters()) == n, (target, name)
            continue
        assert type(port).__name__ == type(ref).__name__, target
        assert sum(p.numel() for p in port.parameters()) == _ref_count(ref, node["params"]), target


def _ref_count(ref, p: dict) -> int:
    """The JAX module's parameter count, initialised on small inputs."""
    key = jax.random.PRNGKey(0)
    if type(ref).__name__ == "AutoencoderKL1D":
        args = (jnp.zeros((1, 16, p["ddconfig"]["in_channels"])),)
        tree = jax.eval_shape(lambda: ref.init(key, *args, method=type(ref).encode_moments))
        dec = jax.eval_shape(lambda: ref.init(key, jnp.zeros((1, 8, 4)), method=type(ref).decode))
        return _leaves(tree["params"]) + _leaves(dec["params"]) - _leaves(
            {k: v for k, v in dec["params"].items() if k in tree["params"]})
    if type(ref).__name__ == "AutoencoderKL2D":
        args = (jnp.zeros((1, 16, 12, 1)), key)
    else:
        b, n = 1, 6
        args = [jnp.zeros((b, 6, p["in_channels"])), jnp.zeros((b,), jnp.int32),
                jnp.zeros((b, n, p["context_dim"]))]
        if type(ref).__name__ == "ConcatOrderDiT":
            args.append(jnp.zeros((b, n), jnp.int32))
        elif type(ref).__name__ == "ConcatOrderDiT2":
            args += [jnp.zeros((b, n + 2), jnp.int32), jnp.zeros((b, n + 2), jnp.int32)]
        if type(ref).__name__ != "TxtFlagLargeDiT":
            args.append(jnp.zeros((b, 256)))
    return _leaves(jax.eval_shape(lambda: ref.init(key, *args))["params"])


def test_system_config_builds_the_named_classes():
    """An LDM whose unet is ConcatDiT, first stage the 2D VAE and cond a
    T5-only conditioner: build_dit / build_vae build those classes, and the
    absent CLAP tower raises."""
    cfg = {"model": {"params": {
        "unet_config": {"target": "ldm.modules.diffusionmodules.concatDiT.ConcatDiT",
                        "params": DIT_PARAMS},
        "first_stage_config": {"target": "ldm.models.autoencoder.AutoencoderKL",
                               "params": _registry_params("ldm.models.autoencoder.AutoencoderKL")},
        "cond_stage_config": {"target": "ldm.modules.encoders.modules.FrozenFLANEmbedder",
                              "params": {"t5_config": T5}}}}}
    sys_cfg = t_cfg.parse_diffusion_config(cfg)
    assert type(sys_cfg.build_dit()).__name__ == "ConcatDiT"
    assert type(sys_cfg.build_vae()).__name__ == "AutoencoderKL2D"
    assert sys_cfg.build_t5().config.d_model == 16
    with pytest.raises(ValueError, match="single-tower"):
        sys_cfg.build_clap_text()
    with pytest.raises(TypeError):
        sys_cfg.build_dit(use_flash=True)  # ConcatDiT has no flash knob, as in JAX


@pytest.mark.parametrize("unet", ["ldm.modules.diffusionmodules.concatDiT.ConcatDiT",
                                  "ldm.modules.diffusionmodules.flag_large_dit.TxtFlagLargeDiT"])
def test_teacher_cli_trains_variant_unets(tmp_path, monkeypatch, unet):
    """The training CLI's teacher branch builds the unet the YAML names and
    trains it for an epoch (4 steps), as the JAX CLI does on this config."""
    import audiolcm_torch.api as api

    monkeypatch.setattr(api, "Tokenizers", StubTokenizers)
    (tmp_path / "data").mkdir()
    _manifest(tmp_path / "data", 8)
    cfg = _diffusion_cfg(tmp_path / "data", "ldm.models.diffusion.ddpm_audio.LatentDiffusion_audio")
    cfg["model"]["params"]["unet_config"] = {"target": unet, "params": dict(
        DIT_PARAMS, context_dim=16, max_len=256)}
    rundir, lines, ckpts = _run(tmp_path, cfg, ["--model.params.ckpt_path", "/nonexistent.ckpt"])
    _val(lines, "val/loss_simple")
    assert ckpts == ["4"]
    sd = torch.load(rundir / "checkpoints" / "4" / "state.pt", weights_only=True)
    key = "c_embedder.mlp.0.weight" if unet.endswith("ConcatDiT") else "cap_proj.weight"
    assert sd["step"] == 4 and key in sd["model"]
