"""Port parity: audiolcm_torch.data.melprep (csv module) against
audiolcm_tpu.data.melprep (pandas) on the CPU, and the bucket lattice
against audiolcm_tpu.data.buckets.

process_tsv runs on three tiny synthetic wavs and one row whose wav is
missing. The port's table, with one worker and with two worker
subprocesses, must be identical text to the JAX package's one-worker table
(its own tests hold its N-worker run to that), and the mels agree to atol
1e-4 (log10-mel in f32, sums in another order).
"""

import os

import numpy as np
import pytest

from audiolcm_torch.data import buckets as t_buckets
from audiolcm_torch.data import melprep as t_prep
from audiolcm_tpu.data import buckets as j_buckets
from audiolcm_tpu.data import melprep as j_prep
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)


def _tsv(tmp_path):
    """Three wavs (16 kHz int16 mono, 44.1 kHz int16 stereo, 16 kHz float32)
    and a row whose wav does not exist, in the reference TSV layout."""
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    specs = [("tone", 16000, 8000, 1, np.int16), ("stereo", 44100, 30000, 2, np.int16),
             ("float", 16000, 5000, 1, np.float32)]
    rows = []
    for name, sr, n, ch, dtype in specs:
        wav = 0.3 * rng.standard_normal((n, ch) if ch > 1 else n)
        path = tmp_path / f"{name}.wav"
        wavfile.write(path, sr, (wav * 32767).astype(dtype) if dtype == np.int16
                      else wav.astype(dtype))
        rows.append(f"{name}\tt\ta {name}\t{path}")
    rows.insert(1, f"broken\tt\tnothing\t{tmp_path / 'missing.wav'}")
    tsv = tmp_path / "in.tsv"
    tsv.write_text("name\tdataset\tori_cap\taudio_path\n" + "\n".join(rows) + "\n")
    return str(tsv)


@pytest.fixture(scope="module")
def jax_table(tmp_path_factory):
    """The input TSV and the JAX package's one-worker output table and mels."""
    tmp = tmp_path_factory.mktemp("melprep")
    tsv, out = _tsv(tmp), tmp / "jax.tsv"
    df = j_prep.process_tsv(tsv, out_tsv=str(out), mel_dir=str(tmp / "jmels"),
                            max_duration_s=0.4)
    return tsv, out.read_text().replace(str(tmp / "jmels"), "MELS"), list(df["mel_path"])


@pytest.mark.parametrize("num_workers", [1, 2])
def test_process_tsv_matches_jax(jax_table, tmp_path, num_workers):
    tsv, j_text, j_mels = jax_table
    t_out = tmp_path / "port.tsv"
    rows = t_prep.process_tsv(tsv, out_tsv=str(t_out), mel_dir=str(tmp_path / "tmels"),
                              max_duration_s=0.4, num_workers=num_workers, device="cpu")
    assert [r["name"] for r in rows] == ["tone", "stereo", "float"]
    assert t_out.read_text().replace(str(tmp_path / "tmels"), "MELS") == j_text
    for ours, ref in zip(rows, j_mels):
        a, b = np.load(ours["mel_path"]), np.load(ref)
        assert a.shape == b.shape and a.shape[0] == 80 and a.shape[1] <= 25
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_skip_existing_resumes(tmp_path):
    tsv = _tsv(tmp_path)
    mel_dir = tmp_path / "mels"
    first = t_prep.process_tsv(tsv, out_tsv=str(tmp_path / "o.tsv"), mel_dir=str(mel_dir),
                               device="cpu")
    mtimes = {r["mel_path"]: os.path.getmtime(r["mel_path"]) for r in first}
    again = t_prep.process_tsv(tsv, out_tsv=str(tmp_path / "o.tsv"), mel_dir=str(mel_dir),
                               skip_existing=True, device="cpu")
    assert {r["mel_path"]: os.path.getmtime(r["mel_path"]) for r in again} == mtimes
    np.testing.assert_allclose([r["duration"] for r in again], [r["duration"] for r in first],
                               atol=0.02)


def test_load_wav_matches_jax(tmp_path):
    tsv = _tsv(tmp_path)
    for row in t_prep.read_tsv(tsv)[1]:
        ours, ref = t_prep.load_wav_mono_16k(row["audio_path"]), j_prep.load_wav_mono_16k(
            row["audio_path"])
        if ref is None:
            assert ours is None
        else:
            np.testing.assert_array_equal(ours, ref)


def test_buckets_match_jax():
    assert t_buckets.DEFAULT_MEL_BUCKETS == j_buckets.DEFAULT_MEL_BUCKETS
    assert (t_buckets.PAD_VALUE, t_buckets.MIN_LEN, t_buckets.MAX_LEN) == (
        j_buckets.PAD_VALUE, j_buckets.MIN_LEN, j_buckets.MAX_LEN)
    for n in range(0, 1400):
        assert t_buckets.bucket_for_length(n) == j_buckets.bucket_for_length(n)
        assert t_buckets.reference_pad_length([n, 3]) == j_buckets.reference_pad_length([n, 3])
    lattice = (100, 200, 300)
    for n in (1, 99, 100, 101, 250, 301, 5000):
        assert t_buckets.bucket_for_length(n, lattice) == j_buckets.bucket_for_length(n, lattice)
