"""The port's standalone vocoder CLI (`audiolcm_torch/cli/vocoder_infer.py`)
against the JAX package's (`audiolcm_tpu/cli/vocoder_infer.py`): both modes
(mel .npy files; wavs through the natural-log mel) and both checkpoint
layouts (a vocoder directory with args.yml; a generator file with a
sibling config.json), on the synthetic checkpoint of
tests/test_vocoder_infer_cli.py, on the CPU.

Both write int16 wavs of the same names, rates and lengths; the samples
agree within 2 LSB (f32 outputs that differ by ~1e-6 can round to
neighbouring int16 values, and the wav mode adds the mel's own ~1e-5).
"""

import json
import shutil

import numpy as np
import pytest
from scipy.io import wavfile

from audiolcm_torch.cli import vocoder_infer as t_cli
from audiolcm_tpu.cli import vocoder_infer as j_cli
from tests.test_vocoder_infer_cli import VOC_ARGS, voc_dir  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)


def _run_both(args, tmp_path):
    """Run both CLIs with `args` into their own output dirs; returns
    {name: (port wav, jax wav)} after checking names and rates."""
    j_cli.main(args + ["--output_dir", str(tmp_path / "jax")])
    t_cli.main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and names
    out = {}
    for name in names:
        (sr_t, wav_t), (sr_j, wav_j) = (wavfile.read(tmp_path / d / name) for d in ("port", "jax"))
        assert sr_t == sr_j == 16000 and wav_t.dtype == wav_j.dtype == np.int16
        assert wav_t.shape == wav_j.shape
        np.testing.assert_allclose(wav_t.astype(np.int32), wav_j.astype(np.int32), atol=2)
        out[name] = wav_t, wav_j
    return out


def test_mel_mode_matches_jax(voc_dir, tmp_path):  # noqa: F811
    mels = tmp_path / "mels"
    mels.mkdir()
    rng = np.random.default_rng(0)
    for name, t in (("a", 12), ("b", 16)):
        np.save(mels / f"{name}.npy", rng.standard_normal((8, t)).astype(np.float32))
    np.save(mels / "c.npy", rng.standard_normal((1, 8, 12)).astype(np.float32))  # (1, mels, T)
    (mels / "ignored.txt").write_text("not a mel")
    wavs = _run_both(["--input_mels_dir", str(mels), "--checkpoint_file", str(voc_dir)],
                     tmp_path)
    assert sorted(wavs) == ["a_generated_e2e.wav", "b_generated_e2e.wav", "c_generated_e2e.wav"]
    assert wavs["b_generated_e2e.wav"][0].shape == (16 * 8,)
    assert np.abs(wavs["a_generated_e2e.wav"][0]).max() > 0


def test_wav_mode_with_file_checkpoint_matches_jax(voc_dir, tmp_path):  # noqa: F811
    ckpt = tmp_path / "g"
    ckpt.mkdir()
    shutil.copy(voc_dir / "best_netG.pt", ckpt / "g_05000000.pt")
    (ckpt / "config.json").write_text(json.dumps(VOC_ARGS))
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(1)
    wavfile.write(wavs / "clip.wav", 16000, (rng.standard_normal(400) * 3000).astype(np.int16))
    wavfile.write(wavs / "hi.wav", 32000, (rng.standard_normal(800) * 3000).astype(np.int16))
    (wavs / "broken.wav").write_text("not a wav")
    out = _run_both(["--input_wavs_dir", str(wavs),
                     "--checkpoint_file", str(ckpt / "g_05000000.pt")], tmp_path)
    assert sorted(out) == ["clip_generated.wav", "hi_generated.wav"]


def test_runs_on_the_card_by_default(voc_dir, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        t_cli.main(["--input_mels_dir", str(tmp_path), "--checkpoint_file", str(voc_dir)])
