"""Port parity: the LAION open_clap audio side and the CLAP model
(`audiolcm_torch/models/open_clap/`) against `audiolcm_tpu.models.open_clap`
at tiny widths on the CPU. Parameters and BatchNorm statistics come from a
numpy seed (`random_params`: never the identity statistics), reach JAX
directly and the port through `convert.open_clap_from_jax`. Bars: the
Swin block, the fusion modules and the joint embeddings atol 2e-5; whole
HTSAT / PANN outputs 1e-4 of the output's largest value (BatchNorms
inside); the bicubic resize 1e-5 of scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch.convert import _fusion_from_jax, open_clap_from_jax
from audiolcm_torch.models.open_clap import factory as t_factory
from audiolcm_torch.models.open_clap import fusion as t_fusion
from audiolcm_torch.models.open_clap import htsat as t_htsat
from audiolcm_torch.models.open_clap import model as t_model
from audiolcm_torch.models.open_clap import pann as t_pann
from audiolcm_tpu.models.open_clap import fusion as j_fusion
from audiolcm_tpu.models.open_clap import htsat as j_htsat
from audiolcm_tpu.models.open_clap import model as j_model
from audiolcm_tpu.models.open_clap import pann as j_pann
from test_torch_text import random_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

# tests/test_open_clap.py:_tiny_htsat with three stages: the last one (4 x 4
# tokens, window 4) takes the no-shift branch, the first two shift
HTSAT_TINY = dict(spec_size=64, patch_size=4, patch_stride=(4, 4), embed_dim=16,
                  depths=(2, 2, 2), num_heads=(2, 2, 2), window_size=4, num_classes=10,
                  mel_bins=16, sample_rate=8000, hop_size=80, window_size_stft=256)
# the 1D fusion's mel conv is 64 channels wide: 64 mel bins, freq ratio 1
HTSAT_1D = dict(HTSAT_TINY, mel_bins=64)
PANN_TINY = dict(sample_rate=8000, window_size=256, hop_size=80, classes_num=7)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _init(module, seed: int, **inputs) -> dict:
    """Random numpy variables of a JAX module at `inputs`' shapes."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), **{
        k: jnp.asarray(v) for k, v in inputs.items()}))
    return random_params(dict(shapes), seed)


def _audio_inputs(seed: int, mel_bins: int, frames: int, b: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {"mel_fusion": rng.standard_normal((b, 4, frames, mel_bins)).astype(np.float32),
            "longer": np.array([True, False, True][:b])}


def _port_clap(cfg, variables) -> t_model.OpenClap:
    model = t_model.OpenClap(cfg)
    model.load_state_dict(open_clap_from_jax(variables, cfg), strict=True)
    return model.eval()


def _to_torch(inputs: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}


def _swin_sd(p: dict) -> dict:
    t = lambda a: torch.from_numpy(np.asarray(a))
    sd = {"attn.relative_position_bias_table": t(p["attn"]["relative_position_bias_table"])}
    for jn, tn in (("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"), ("qkv", "attn.qkv"),
                   ("proj", "attn.proj")):
        leaf = p["attn"][jn] if jn in ("qkv", "proj") else p[jn]
        sd[f"{tn}.weight"], sd[f"{tn}.bias"] = t(leaf["kernel"]).T, t(leaf["bias"])
    for n in ("norm1", "norm2"):
        sd[f"{n}.weight"], sd[f"{n}.bias"] = t(p[n]["scale"]), t(p[n]["bias"])
    return sd


@pytest.mark.parametrize("res,shift", [((8, 8), 2), ((8, 8), 0), ((4, 4), 2)])
def test_swin_block(res, shift):
    """Shifted, unshifted, and at the window size (the shift switched off)."""
    dim, heads, ws = 8, 2, 4
    x = np.random.default_rng(1).standard_normal((2, res[0] * res[1], dim)).astype(np.float32)
    jb = j_htsat.SwinBlock(dim, res, heads, ws, shift, mlp_ratio=2.0)
    v = _init(jb, 2, x=x)
    golden = jb.apply(v, jnp.asarray(x))
    tb = t_htsat.SwinBlock(dim, res, heads, ws, shift, mlp_ratio=2.0)
    tb.load_state_dict(_swin_sd(v["params"]), strict=True)
    with torch.no_grad():
        out = tb(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(golden), atol=2e-5)


@pytest.mark.parametrize("kind", ["aff", "iaff", "daf"])
@pytest.mark.parametrize("dims", ["1D", "2D"])
def test_fusion(kind, dims):
    """The reference's channels-first layout against JAX's channels-last;
    iAFF's global_att2 gets its init and is never called."""
    shape = (2, 5, 7, 8) if dims == "2D" else (2, 11, 8)
    rng = np.random.default_rng(3)
    x, r = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    cf = lambda a: torch.from_numpy(np.moveaxis(a, -1, 1).copy())
    port = t_fusion.fusion_module(f"{kind}_{dims.lower()}", 8)
    if kind == "daf":
        golden = j_fusion.daf(jnp.asarray(x), jnp.asarray(r))
    else:
        jmod = (j_fusion.AFF if kind == "aff" else j_fusion.iAFF)(channels=8)
        v = _init(jmod, 4, x=x, residual=r)
        sd = {}
        _fusion_from_jax(v["params"], v["batch_stats"], "f", sd)
        port.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
        golden = jmod.apply(v, jnp.asarray(x), jnp.asarray(r))
    with torch.no_grad():
        out = port(cf(x), cf(r))
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), np.asarray(golden), atol=2e-5)


@pytest.mark.parametrize("n_in,n_out", [(101, 256), (37, 64), (16, 16)])
def test_bicubic_resize(n_in, n_out):
    """torch's bicubic (align_corners, A = -0.75, clamped edges) along one
    axis at lengths that are not multiples, edges included, and the
    identity at equal lengths."""
    x = np.random.default_rng(5).standard_normal((2, n_in, 3)).astype(np.float32)
    golden = np.asarray(j_htsat.bicubic_align_corners_1d(jnp.asarray(x), n_out, axis=1))
    out = t_htsat.bicubic_align_corners_1d(torch.from_numpy(x), n_out, dim=1).numpy()
    assert out.shape == golden.shape == (2, n_out, 3)
    assert _rel(out, golden) <= 1e-5
    np.testing.assert_array_equal(out[:, [0, -1]], x[:, [0, -1]])


def _clap_cfgs(audio_cls_j, audio_cls_t, audio_kw: dict, embed_dim: int):
    text = dict(text_model_type="transformer", text_width=16, text_layers=1, text_heads=2,
                text_vocab=50, context_length=12, joint_embed_shape=24)
    return (j_model.OpenClapConfig(embed_dim=embed_dim, audio=audio_cls_j(**audio_kw), **text),
            t_model.OpenClapConfig(embed_dim=embed_dim, audio=audio_cls_t(**audio_kw), **text))


def _check_audio(jcfg, tcfg, inputs: dict, seed: int) -> None:
    """encode_audio's every output relative to its scale, and the projected
    embedding at atol 2e-5."""
    jm = j_model.OpenClap(jcfg)
    ids = np.zeros((1, 12), np.int32)
    v = _init(jm, seed, input_ids=ids, **inputs)
    golden = jm.apply(v, **{k: jnp.asarray(a) for k, a in inputs.items()},
                      method=jm.encode_audio)
    emb = jm.apply(v, **{k: jnp.asarray(a) for k, a in inputs.items()},
                   method=jm.get_audio_embedding)
    port = _port_clap(tcfg, v)
    with torch.no_grad():
        out = port.encode_audio(**_to_torch(inputs))
        pemb = port.get_audio_embedding(**_to_torch(inputs))
    assert set(out) == set(golden)
    for key in golden:
        assert out[key].shape == golden[key].shape, key
        assert _rel(out[key].numpy(), golden[key]) <= 1e-4, key
    np.testing.assert_allclose(pemb.numpy(), np.asarray(emb), atol=2e-5)


def test_htsat_waveform():
    jcfg, tcfg = _clap_cfgs(j_htsat.HTSATConfig, t_htsat.HTSATConfig, HTSAT_TINY, 64)
    wav = np.random.default_rng(6).standard_normal((2, 8000)).astype(np.float32)
    _check_audio(jcfg, tcfg, {"waveform": wav}, 7)


@pytest.mark.parametrize("fusion_type", ["aff_2d", "iaff_2d", "daf_2d", "aff_1d"])
def test_htsat_mel_fusion_longer(fusion_type):
    """The mel_fusion path with mixed `longer` flags, T = 101 frames resized
    to the lattice (the 1D fusion: 50 frames of 64 mel bins)."""
    kw = dict(HTSAT_1D if fusion_type.endswith("1d") else HTSAT_TINY, enable_fusion=True,
              fusion_type=fusion_type)
    jcfg, tcfg = _clap_cfgs(j_htsat.HTSATConfig, t_htsat.HTSATConfig, kw, 64)
    frames = 50 if fusion_type.endswith("1d") else 101
    _check_audio(jcfg, tcfg, _audio_inputs(8, kw["mel_bins"], frames), 9)


@pytest.mark.parametrize("model_name,fusion_type", [("Cnn14", "None"), ("Cnn10", "aff_2d"),
                                                    ("Cnn6", "iaff_1d"),
                                                    ("Cnn10", "channel_map")])
def test_pann(model_name, fusion_type):
    kw = dict(PANN_TINY, model_name=model_name, enable_fusion=fusion_type != "None",
              fusion_type=fusion_type)
    emb = t_pann.PLANS[model_name][-1]
    jcfg, tcfg = _clap_cfgs(j_pann.PannConfig, t_pann.PannConfig, kw, emb)
    if fusion_type == "None":
        inputs = {"waveform": np.random.default_rng(10).standard_normal((1, 8000)).astype(
            np.float32)}
    else:
        inputs = _audio_inputs(11, 64, 101, b=2)
    _check_audio(jcfg, tcfg, inputs, 12)


def test_open_clap_six_tuple():
    """The forward's 6-tuple: unit audio and text embeddings, their
    transforms and exp of the logit scales (init log(1/0.07) on the port)."""
    jcfg, tcfg = _clap_cfgs(j_htsat.HTSATConfig, t_htsat.HTSATConfig,
                            dict(HTSAT_TINY, enable_fusion=True, fusion_type="aff_2d"), 64)
    inputs = _audio_inputs(13, 16, 101)
    ids = np.random.default_rng(14).integers(0, 50, (3, 12)).astype(np.int32)
    jm = j_model.OpenClap(jcfg)
    v = _init(jm, 15, input_ids=ids, **inputs)
    golden = jm.apply(v, input_ids=jnp.asarray(ids), **{k: jnp.asarray(a) for k, a in
                                                         inputs.items()})
    port = _port_clap(tcfg, v)
    with torch.no_grad():
        out = port(input_ids=torch.from_numpy(ids).long(), **_to_torch(inputs))
    assert len(out) == 6
    for got, want in zip(out, golden):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(out[0].numpy(), axis=-1), 1.0, atol=1e-5)
    fresh = t_model.OpenClap(tcfg)
    assert abs(float(fresh.logit_scale_a.detach().exp()) - 1 / 0.07) < 1e-3


def test_checkpoint_loads_strictly(tmp_path, monkeypatch):
    """open_clap_from_jax's state dict, dressed as a reference checkpoint (a
    `module.` prefix, the buffers the port derives, HTSAT's unused head, HF's
    position ids), loads with strict=True through the factory's loader and
    reproduces JAX's text and audio embeddings; a roberta text branch at
    tiny width on both sides; a transformer-branch checkpoint raises."""
    from audiolcm_torch.models.open_clap.text_towers import RobertaConfig as TRoberta
    from audiolcm_tpu.models.open_clap.text_towers import RobertaConfig as JRoberta

    tiny = dict(vocab_size=60, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
                max_position_embeddings=20)
    monkeypatch.setattr(j_model, "RobertaConfig", lambda: JRoberta(**tiny))
    kw = dict(HTSAT_TINY, enable_fusion=True, fusion_type="iaff_2d")
    text = dict(text_model_type="roberta", joint_embed_shape=24)
    jcfg = j_model.OpenClapConfig(embed_dim=64, audio=j_htsat.HTSATConfig(**kw), **text)
    tcfg = t_model.OpenClapConfig(embed_dim=64, audio=t_htsat.HTSATConfig(**kw),
                                  text_config=TRoberta(**tiny), **text)
    inputs = _audio_inputs(16, 16, 101)
    ids = np.random.default_rng(17).integers(3, 60, (3, 12)).astype(np.int32)
    ids[0, 8:] = 1
    mask = (ids != 1).astype(np.int32)
    jm = j_model.OpenClap(jcfg)
    v = _init(jm, 18, input_ids=ids, attention_mask=mask, **inputs)
    golden = jm.apply(v, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                      **{k: jnp.asarray(a) for k, a in inputs.items()})

    sd = {f"module.{k}": t for k, t in open_clap_from_jax(v, tcfg).items()}
    assert any(".global_att2." in k for k in sd)
    extra = {"audio_branch.spectrogram_extractor.stft.conv_real.weight": torch.zeros(3),
             "audio_branch.logmel_extractor.melW": torch.zeros(3),
             "audio_branch.head.weight": torch.zeros(10, 10),
             "audio_branch.layers.0.blocks.0.attn.relative_position_index": torch.zeros(3),
             "audio_branch.layers.0.blocks.1.attn_mask": torch.zeros(3),
             "text_branch.embeddings.position_ids": torch.zeros(3)}
    sd.update({f"module.{k}": t for k, t in extra.items()})
    path = tmp_path / "clap.pt"
    torch.save({"epoch": 1, "state_dict": sd}, path)
    port = t_factory.load_checkpoint(t_model.OpenClap(tcfg), str(path)).eval()
    with torch.no_grad():
        out = port(input_ids=torch.from_numpy(ids).long(),
                   attention_mask=torch.from_numpy(mask), **_to_torch(inputs))
    for got, want in zip(out, golden):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)

    bad = dict(sd, **{"module.audio_branch.norm.extra": torch.zeros(1)})
    torch.save({"state_dict": bad}, path)
    with pytest.raises(RuntimeError, match="Unexpected"):
        t_factory.load_checkpoint(t_model.OpenClap(tcfg), str(path))
    clip_cfg = t_model.OpenClapConfig(embed_dim=64, audio=None, text_model_type="transformer",
                                      text_width=16, text_layers=1, text_heads=2)
    with pytest.raises(ValueError, match="transformer"):
        t_factory.load_checkpoint(t_model.OpenClap(clip_cfg), str(path))


def test_factory_configs():
    """The factory's table against JAX's: every name, each audio config
    and embed_dim equal field by field."""
    from audiolcm_tpu.models.open_clap import factory as j_factory

    assert t_factory.list_models() == j_factory.list_models()
    assert len(t_factory.MODEL_CONFIGS) == 11
    for name in t_factory.list_models():
        for fusion in ((False, "None"), (True, "aff_2d")):
            a, b = t_factory.build_config(name, "roberta", *fusion), j_factory.build_config(
                name, "roberta", *fusion)
            assert (a.embed_dim, a.text_layers) == (b.embed_dim, b.text_layers)
            assert dataclasses_equal(a.audio, b.audio), name
    with pytest.raises(RuntimeError):
        t_factory.build_config("nope", "roberta")


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return (type(a).__name__ == type(b).__name__
            and dataclasses.asdict(a) == dataclasses.asdict(b))
