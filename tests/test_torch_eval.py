"""Port parity: the eval stack (`audiolcm_torch/eval/`, `models/vggish.py`,
`models/clap_audio.py`, `models/clap.py`) and its CLIs against
audiolcm_tpu, f32 on the CPU, on random state dicts in each reference
layout (no CLAP, VGGish or tokenizer assets exist here).

Sizes: wavs of 0.25-2 s; Cnn14 at its fixed widths (64..2048) on an 8 kHz
configuration with a 64-sample window and hop 32, as `tests/test_eval.py`
runs it; a one-layer BERT of width 16. Bars: rtol 1e-5 / atol 1e-5 of the
output's scale, except the two deep towers: VGGish's embeddings (six convs
and three Linears over 12288 / 4096 inputs) and Cnn14's (twelve convs with
BatchNorm) are held at rtol 1e-4 of the output's largest value, since
their sums run in another order in XLA's and torch's CPU convolutions.
The CLAP score and FAD are held at 1e-4 relative.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch.eval import clap_score as t_cs
from audiolcm_torch.eval import fad as t_fad
from audiolcm_torch.eval import mrstft as t_mr
from audiolcm_torch.models import clap as t_clap
from audiolcm_torch.models import clap_audio as t_ca
from audiolcm_torch.models import vggish as t_vg
from audiolcm_torch.models.clap_text import BertConfig as TBertConfig
from audiolcm_tpu.convert import convert_bert
from audiolcm_tpu.eval import clap_score as j_cs
from audiolcm_tpu.eval import fad as j_fad
from audiolcm_tpu.eval import mrstft as j_mr
from audiolcm_tpu.models import clap as j_clap
from audiolcm_tpu.models import clap_audio as j_ca
from audiolcm_tpu.models import vggish as j_vg
from audiolcm_tpu.models.clap_text import BertConfig as JBertConfig
from tests.test_api import synthetic_ckpt  # noqa: F401  (module-scoped fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

AUDIO = dict(sample_rate=8000, window_size=64, hop_size=32, mel_bins=64, fmin=50, fmax=4000,
             out_emb=32)
BERT = dict(vocab_size=40, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
            max_position_embeddings=80)
D_PROJ = 24
TOL = dict(rtol=1e-5, atol=1e-5)


def _randomize_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fan-in-scaled weights, norm scales ~1, small biases, BatchNorm
    statistics away from (0, 1): O(1) activations through every layer."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=g) * p[0].numel() ** -0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    return module.eval()


def _np_sd(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _close_to_scale(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def test_mrstft_matches_jax(rng):
    y = (0.3 * rng.standard_normal((2, 4000))).astype(np.float32)
    y_hat = (y + 0.05 * rng.standard_normal(y.shape)).astype(np.float32)
    got = t_mr.mrstft_loss(torch.from_numpy(y), torch.from_numpy(y_hat))
    want = j_mr.mrstft_loss(jnp.asarray(y), jnp.asarray(y_hat))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert float(t_mr.mrstft_loss(torch.from_numpy(y), torch.from_numpy(y))) < 1e-6


def test_frechet_distance_and_fad_match_jax(rng):
    """The distance of two Gaussians (and the eps fallback on singular
    covariances), the statistics and fad_score under one embedding."""
    a = rng.standard_normal((40, 6))
    b = rng.standard_normal((30, 6)) * 1.3 + 0.4
    for x, y in ((a, b), (a[:3], b[:2])):  # the second pair: rank-deficient covariances
        got = t_fad.frechet_distance(*t_fad.embedding_statistics(x), *t_fad.embedding_statistics(y))
        want = j_fad.frechet_distance(*j_fad.embedding_statistics(x),
                                      *j_fad.embedding_statistics(y))
        assert got == pytest.approx(want, rel=1e-10)
    embed = lambda w: np.stack([w[:50], w[50:100]]).astype(np.float64)
    gen = [rng.standard_normal(200) for _ in range(4)]
    bg = [rng.standard_normal(200) + 0.2 for _ in range(5)]
    assert t_fad.fad_score(embed, gen, bg) == pytest.approx(j_fad.fad_score(embed, gen, bg),
                                                            rel=1e-10)


def test_logmel_stats_embedder_matches_jax(rng):
    for n in (500, 16000):  # shorter than n_fft + hop: zero-padded
        wav = (0.2 * rng.standard_normal(n)).astype(np.float32)
        got = t_fad.make_logmel_stats_embedder("cpu")(wav)
        want = j_fad.make_logmel_stats_embedder()(wav)
        assert got.shape == (1, 160)
        _close_to_scale(got, want, 1e-5)


def test_load_wav_dir_matches_jax(tmp_path, rng):
    from scipy.io import wavfile

    for i in range(3):
        w = (0.3 * rng.standard_normal(800)).astype(np.float32)
        wavfile.write(tmp_path / f"c{i}.wav", 16000, (w * 32767).astype(np.int16))
    wavfile.write(tmp_path / "f.wav", 16000, np.ones(10, np.float32))
    got, want = t_fad.load_wav_dir(str(tmp_path), 3), j_fad.load_wav_dir(str(tmp_path), 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)


@pytest.fixture(scope="module")
def vggish_sd():
    torch.manual_seed(0)
    return _np_sd(_randomize_(t_vg.VGGish(), 1))


def test_vggish_frontend_matches_jax(rng):
    cfg = t_vg.VGGishConfig()
    np.testing.assert_array_equal(t_vg.vggish_mel_matrix(cfg), j_vg.vggish_mel_matrix())
    wav = (0.1 * rng.standard_normal((2, 32000))).astype(np.float32)
    got = t_vg.vggish_log_mel_examples(torch.from_numpy(wav), cfg)
    want = j_vg.vggish_log_mel_examples(jnp.asarray(wav))
    assert got.shape == (2, 2, 96, 64)
    _close_to_scale(got.numpy(), want, 1e-5)


def test_vggish_matches_jax(vggish_sd, rng):
    """The tower on log-mel examples (with and without the last ReLU), the
    whole embed_waveform, and the PCA postprocessor."""
    model = t_vg.load_vggish({k: torch.from_numpy(v) for k, v in vggish_sd.items()})
    jv = jax.tree.map(jnp.asarray, j_vg.convert_vggish(vggish_sd))
    jm = j_vg.VGGish()
    wav = (0.1 * rng.standard_normal((1, 32000))).astype(np.float32)
    with torch.no_grad():
        got = model.embed_waveform(torch.from_numpy(wav))
        got_relu = model.embed_waveform(torch.from_numpy(wav), include_final_relu=True)
    want = jm.embed_waveform(jv, jnp.asarray(wav))
    assert got.shape == (2, 128) and (got < 0).any()
    _close_to_scale(got.numpy(), want, 1e-4)
    _close_to_scale(got_relu.numpy(), jm.embed_waveform(jv, jnp.asarray(wav),
                                                        include_final_relu=True), 1e-4)
    pca = rng.standard_normal((128, 128)).astype(np.float32) * 0.1
    means = rng.standard_normal(128).astype(np.float32)
    emb = rng.standard_normal((3, 128)).astype(np.float32)
    for q in (False, True):
        np.testing.assert_allclose(
            t_vg.vggish_postprocess(torch.from_numpy(emb), torch.from_numpy(pca),
                                    torch.from_numpy(means), q).numpy(),
            np.asarray(j_vg.vggish_postprocess(jnp.asarray(emb), jnp.asarray(pca),
                                               jnp.asarray(means), q)), **TOL)


def test_logmel_torchlibrosa_matches_jax(rng):
    wav = (0.1 * rng.standard_normal((2, 4000))).astype(np.float32)
    got = t_ca.logmel_torchlibrosa(torch.from_numpy(wav), t_ca.ClapAudioConfig(**AUDIO))
    want = j_ca.logmel_torchlibrosa(jnp.asarray(wav), j_ca.ClapAudioConfig(**AUDIO))
    assert got.shape == (2, 126, 64)
    _close_to_scale(got.numpy(), want, 1e-5)


@pytest.fixture(scope="module")
def clap_sd():
    """A random CLAP state dict in the reference layout: a tiny BERT, Cnn14
    on the 8 kHz configuration, d_proj 24."""
    torch.manual_seed(0)
    model = t_clap.CLAP(TBertConfig(**BERT), t_ca.ClapAudioConfig(**AUDIO), D_PROJ)
    return _np_sd(_randomize_(model, 2))


def _jax_clap_variables(sd: dict) -> dict:
    strip = lambda p: {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
    proj = lambda p: {"linear1": {"kernel": sd[p + "linear1.weight"].T},
                      "linear2": {"kernel": sd[p + "linear2.weight"].T},
                      "layer_norm": {"scale": sd[p + "layer_norm.weight"],
                                     "bias": sd[p + "layer_norm.bias"]}}
    cnn = j_ca.convert_cnn14(strip("audio_encoder.base."))
    params = {"caption_encoder_base": convert_bert(strip("caption_encoder.base."), num_layers=1),
              "caption_projection": proj("caption_encoder.projection."),
              "audio_encoder_base": cnn["params"],
              "audio_projection": proj("audio_encoder.projection."),
              "logit_scale": sd["logit_scale"]}
    return jax.tree.map(jnp.asarray, {"params": params,
                                      "batch_stats": {"audio_encoder_base": cnn["batch_stats"]}})


def test_cnn14_and_clap_match_jax(clap_sd, rng):
    """Cnn14's embedding, then the whole CLAP forward (normalised text and
    audio embeddings, the logit scale) and its contrastive loss."""
    model = t_clap.CLAP(TBertConfig(**BERT), t_ca.ClapAudioConfig(**AUDIO), D_PROJ)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in clap_sd.items()})
    model.eval()
    jm = j_clap.CLAP(JBertConfig(**BERT), j_ca.ClapAudioConfig(**AUDIO), D_PROJ)
    jv = _jax_clap_variables(clap_sd)
    wav = (0.1 * rng.standard_normal((3, 4000))).astype(np.float32)
    ids = rng.integers(0, BERT["vocab_size"], (3, 9))
    with torch.no_grad():
        emb = model.audio_encoder.base(torch.from_numpy(wav))
        t, a, scale = model(torch.from_numpy(ids), torch.from_numpy(wav))
    cnn = jax.jit(j_ca.Cnn14(j_ca.ClapAudioConfig(**AUDIO)).apply)(
        {"params": jv["params"]["audio_encoder_base"],
         "batch_stats": jv["batch_stats"]["audio_encoder_base"]}, jnp.asarray(wav))
    _close_to_scale(emb.numpy(), cnn, 1e-4)
    tj, aj, sj = jax.jit(jm.apply)(jv, jnp.asarray(ids), jnp.asarray(wav))
    _close_to_scale(t.numpy(), tj, 1e-5)
    _close_to_scale(a.numpy(), aj, 1e-4)
    np.testing.assert_allclose(float(scale), float(sj), rtol=1e-6)
    np.testing.assert_allclose(float(t_clap.clap_contrastive_loss(t, a, scale)),
                               float(j_clap.clap_contrastive_loss(tj, aj, sj)), rtol=1e-4)


def test_clap_score_and_cosine_diag_match_jax(rng):
    """The harness (host resample to 44.1 kHz, repeat-pad or crop to 5 s,
    batches, matched cosines) under one cheap embedding pair, a fixed
    projection of the first 2000 samples, on both sides."""
    proj = rng.standard_normal((2000, 8)).astype(np.float32)
    wavs = [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in (4000, 20000, 81000)]
    caps = ["a", "bb", "ccc"]
    text = lambda c: np.stack([np.cos(np.arange(8) * len(s)) for s in c]).astype(np.float32)
    got = t_cs.clap_score(lambda c: torch.from_numpy(text(c)),
                          lambda w: torch.from_numpy(w[:, :2000] @ proj), caps, wavs, batch_size=2)
    want = j_cs.clap_score(lambda c: jnp.asarray(text(c)),
                           lambda w: jnp.asarray(w[:, :2000] @ proj), caps, wavs, batch_size=2)
    assert got == pytest.approx(want, rel=1e-5)
    np.testing.assert_array_equal(t_cs.prepare_clap_audio(wavs[0]),
                                  j_cs.prepare_clap_audio(wavs[0]))
    x, y = rng.standard_normal((4, 8)).astype(np.float32), rng.standard_normal((4, 8)).astype(
        np.float32)
    np.testing.assert_allclose(t_cs.cosine_diag(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(j_cs.cosine_diag(jnp.asarray(x), jnp.asarray(y))), **TOL)
    with pytest.raises(ValueError):
        t_cs.clap_score(None, None, ["a"], [])


def test_add_clap_score_to_csv_matches_jax(tmp_path):
    import pandas as pd

    src = tmp_path / "res.csv"
    src.write_text("caption,audio_path\na dog,/x/a.wav\n\"rain, wind\",/x/b.wav\n")
    t_cs.add_clap_score_to_csv(str(src), [0.25, 0.5], str(tmp_path / "t.csv"))
    j_cs.add_clap_score_to_csv(str(src), [0.25, 0.5], str(tmp_path / "j.csv"))
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "t.csv"), pd.read_csv(tmp_path / "j.csv"))


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


class StubClapTokenizer:
    def __init__(self, *a, **k):
        pass

    def __call__(self, captions):
        return torch.stack([torch.arange(9) * (len(c) + 1) % BERT["vocab_size"]
                            for c in captions])


def _write_wavs(root, n, seed, length=16000, shift=0.0):
    from scipy.io import wavfile

    root.mkdir(parents=True, exist_ok=True)
    r = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        t = np.arange(length) / 16000
        w = 0.3 * np.sin(2 * np.pi * (220 + 40 * i + shift) * t) + 0.05 * r.standard_normal(length)
        paths.append(str(root / f"clip{i}.wav"))
        wavfile.write(paths[-1], 16000, (w * 32767).astype(np.int16))
    return paths


def test_cal_clap_and_fad_cli_on_cpu(tmp_path, monkeypatch, clap_sd, vggish_sd, capsys):
    """cal_clap_score over a result.csv (stub tokenizer, the tiny CLAP file),
    and cal_fad_score with --vggish_ckpt against JAX's FAD under its VGGish
    on the same wavs, at 1e-4 relative."""
    import functools

    from audiolcm_torch.cli import cal_clap_score, cal_fad_score
    from audiolcm_torch.cli.txt2audio_for_lcm import write_result_csv

    monkeypatch.setattr(cal_clap_score, "ClapTokenizer", StubClapTokenizer)
    # the tiny CLAP; Cnn14 reads the 5 s, 44.1 kHz clips with a hop of 1024
    monkeypatch.setattr(cal_clap_score, "build_clap_scorers", functools.partial(
        cal_clap_score.build_clap_scorers, text_config=TBertConfig(**BERT), d_proj=D_PROJ,
        audio_config=t_ca.ClapAudioConfig(**{**AUDIO, "sample_rate": 44100, "window_size": 1024,
                                             "hop_size": 1024, "fmax": 14000})))
    gen = _write_wavs(tmp_path / "gen", 3, 0)
    bg = _write_wavs(tmp_path / "bg", 3, 1, shift=30.0)
    clap_path = tmp_path / "clap.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in clap_sd.items()}}, clap_path)
    write_result_csv(str(tmp_path / "result.csv"),
                     [{"caption": f"sound {i}", "audio_path": p} for i, p in enumerate(gen)])
    score = cal_clap_score.main(["--tsv_path", str(tmp_path / "result.csv"), "--clap_weights",
                                 str(clap_path), "--device", "cpu",
                                 "--out_csv", str(tmp_path / "scored.csv")])
    assert -1.0 <= score <= 1.0 and f"mean clap score: {score:.6f}" in capsys.readouterr().out
    assert open(tmp_path / "scored.csv").readline().split() == ["caption", "audio_path",
                                                                "clap_score_mean"]

    vgg_path = tmp_path / "vggish.pth"
    torch.save({k: torch.from_numpy(v) for k, v in vggish_sd.items()}, vgg_path)
    fad = cal_fad_score.main(["--generated_dir", str(tmp_path / "gen"), "--background_dir",
                              str(tmp_path / "bg"), "--vggish_ckpt", str(vgg_path),
                              "--device", "cpu"])
    jm, jv = j_vg.VGGish(), jax.tree.map(jnp.asarray, j_vg.convert_vggish(vggish_sd))
    want = j_fad.fad_score(lambda w: np.asarray(jm.embed_waveform(jv, jnp.asarray(w)[None])),
                           j_fad.load_wav_dir(str(tmp_path / "gen")),
                           j_fad.load_wav_dir(str(tmp_path / "bg")))
    assert fad == pytest.approx(want, rel=1e-4)
    fad_clap = cal_fad_score.main(["--generated_dir", str(tmp_path / "gen"), "--background_dir",
                                   str(tmp_path / "bg"), "--clap_weights", str(clap_path),
                                   "--limit", "2", "--device", "cpu"])
    assert np.isfinite(fad_clap) and fad_clap >= 0.0


def _acceptance_tsv(tmp_path):
    gt = _write_wavs(tmp_path / "gt", 3, 5, length=4000)
    rows = [f"clip{i}\taudiocaps\tsound number {i}\t\t<sound number {i}& all>\t{p}"
            for i, p in enumerate(gt)]
    tsv = tmp_path / "test.tsv"
    tsv.write_text("name\tdataset\tori_cap\tmel_path\tcaption\taudio_path\n" + "\n".join(rows)
                   + "\n")
    return str(tsv)


def test_eval_acceptance_end_to_end_on_cpu(synthetic_ckpt, tmp_path,  # noqa: F811
                                           monkeypatch, capsys):
    """The loop with stub tokenizers: result.csv and wavs, one JSON line
    equal to acceptance.json with JAX's keys; --skip_generate gives the same
    FAD; without ground truth, the note."""
    import audiolcm_torch.api as api
    from audiolcm_torch.cli import eval_acceptance
    from test_torch_pipeline import StubTokenizers

    monkeypatch.setattr(api, "Tokenizers", lambda *a, **k: StubTokenizers())
    cfg_path, ckpt_path, voc_dir = synthetic_ckpt
    tsv = _acceptance_tsv(tmp_path)
    outdir = tmp_path / "acc"
    argv = ["-b", cfg_path, "--ckpt", ckpt_path, "--vocoder-ckpt", voc_dir, "--tsv", tsv,
            "--outdir", str(outdir), "--W", "8", "--batch_size", "2", "--limit", "2",
            "--device", "cpu"]
    out = eval_acceptance.main(argv)
    assert list(out) == ["n_clips", "outdir", "clap_gt_anchor", "clap_score", "fad_embedder",
                         "fad"]
    assert out["n_clips"] == 2 and out["clap_score"] is None
    assert out["clap_gt_anchor"] == pytest.approx(0.479077)
    assert out["fad_embedder"] == "logmel_stats" and np.isfinite(out["fad"]) and out["fad"] >= 0
    with open(outdir / "acceptance.json") as f:
        assert json.load(f) == out
    printed = [x for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(printed) == 1 and json.loads(printed[0]) == out
    out2 = eval_acceptance.main(argv + ["--skip_generate"])
    assert out2["fad"] == pytest.approx(out["fad"], rel=1e-12)
    os.remove(tsv.replace("test.tsv", "gt/clip0.wav"))
    no_gt = tmp_path / "nogt.tsv"
    no_gt.write_text(open(tsv).read().replace(str(tmp_path / "gt"), "/nonexistent"))
    out3 = eval_acceptance.main(argv[:7] + [str(no_gt)] + argv[8:] + ["--skip_generate"])
    assert out3["fad"] is None and "no ground-truth wavs" in out3["fad_note"]


def test_eval_acceptance_json_matches_jax(synthetic_ckpt, tmp_path, monkeypatch):  # noqa: F811
    """The port's acceptance JSON against JAX's on the same synthetic
    checkpoint, test TSV and ground-truth wavs: the same keys, clip count
    and anchor, and the FAD at 1e-4 relative."""
    import audiolcm_torch.api as t_api
    import audiolcm_tpu.api as j_api
    from audiolcm_torch.cli import eval_acceptance as t_acc
    from audiolcm_tpu.cli import eval_acceptance as j_acc
    from test_torch_pipeline import StubTokenizers as TStub
    from tests.test_api import StubTokenizers as JStub

    monkeypatch.setattr(t_api, "Tokenizers", lambda *a, **k: TStub())
    monkeypatch.setattr(j_api, "Tokenizers", lambda *a, **k: JStub())
    cfg_path, ckpt_path, voc_dir = synthetic_ckpt
    tsv = _acceptance_tsv(tmp_path)
    common = ["-b", cfg_path, "--ckpt", ckpt_path, "--vocoder-ckpt", voc_dir, "--tsv", tsv,
              "--W", "8", "--batch_size", "2", "--limit", "2", "--gt_dir", str(tmp_path / "gt")]
    got = t_acc.main(common + ["--outdir", str(tmp_path / "t"), "--device", "cpu"])
    want = j_acc.main(common + ["--outdir", str(tmp_path / "j")])
    assert set(got) == set(want)
    assert {k: got[k] for k in ("n_clips", "clap_score", "clap_gt_anchor", "fad_embedder")} == {
        k: want[k] for k in ("n_clips", "clap_score", "clap_gt_anchor", "fad_embedder")}
    assert got["fad"] == pytest.approx(want["fad"], rel=1e-4)
