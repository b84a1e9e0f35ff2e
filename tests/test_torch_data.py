"""Port parity: the mel manifest, datasets, batch loaders and struct
captions (`audiolcm_torch/data/`) against audiolcm_tpu's (pandas) on TSVs
with tied durations and empty caption fields. Batches, orders and strings
are held equal exactly; mels are the same files, so equal bit for bit.
"""

import csv
import os

import numpy as np
import pytest

from audiolcm_torch.data import datasets as t_ds
from audiolcm_torch.data import manifest as t_man
from audiolcm_torch.data import struct_captions as t_sc
from audiolcm_tpu.data import datasets as j_ds
from audiolcm_tpu.data import manifest as j_man
from audiolcm_tpu.data import struct_captions as j_sc
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

FIELDS = ["name", "dataset", "ori_cap", "caption", "mel_path", "audio_path", "duration"]


def _write(path, rows, fields=FIELDS):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, delimiter="\t")
        w.writeheader()
        w.writerows(rows)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Two TSVs in one directory (140 + 20 rows) over 8-bin mels of four
    lengths, so durations tie in groups of ~40; every 7th caption and one
    ori_cap empty, one mel path missing, names repeating."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    lens = [40, 70, 100, 130]
    rows = []
    for i in range(160):
        t = lens[int(rng.integers(0, 4))]
        path = root / f"m{i}.npy"
        np.save(path, rng.standard_normal((8, t)).astype(np.float32))
        rows.append({"name": f"clip{i % 150}", "dataset": "syn",
                     "ori_cap": "" if i == 103 else f"a sound {i}",
                     "caption": "" if i % 7 == 0 else f"<sound {i}& start>@<noise& all>",
                     "mel_path": str(root / "missing.npy") if i == 120 else str(path),
                     "audio_path": f"/none/{i}.wav", "duration": t / 62.5})
    _write(root / "a.tsv", rows[:140])
    _write(root / "b.tsv", rows[140:])
    other = root / "other"
    other.mkdir()
    _write(other / "o.tsv", [{k: v for k, v in r.items() if k != "caption"} for r in rows[:45]],
           [f for f in FIELDS if f != "caption"])
    return str(root)


def _jax_rows(df):
    return [{k: (None if isinstance(v, float) and np.isnan(v) else v) for k, v in r.items()}
            for r in df.to_dict("records")]


@pytest.mark.parametrize("split", ["train", "val", "test", "all"])
def test_manifest_split_and_order_match_jax(data_dir, split):
    """Rows, fields (empty -> missing) and the duration order, including
    pandas' unstable quicksort among tied durations."""
    jdf = j_man.split_dataframe(j_man.load_manifests(data_dir), split)
    tm = t_man.split_dataframe(t_man.load_manifests(data_dir), split)
    assert tm.columns == list(jdf.columns)
    want = _jax_rows(jdf)
    for got, exp in zip(tm.rows, want):
        assert got["name"] == exp["name"] and got["caption"] == exp["caption"]
        assert got["ori_cap"] == exp["ori_cap"]
        assert float(got["duration"]) == exp["duration"]
    assert len(tm) == len(want)
    order = t_man.ordered_indices(tm)
    assert order == [int(i) for i in j_man.ordered_indices(jdf)]
    if split in ("train", "all"):  # enough tied rows that quicksort is not stable
        stable = sorted(range(len(tm)), key=lambda i: float(tm.rows[i]["duration"]))
        assert order != stable


def test_integer_durations_sort_as_pandas_int64(tmp_path):
    rows = [{"name": f"n{i}", "dataset": "d", "ori_cap": "c", "caption": "", "mel_path": "",
             "audio_path": "", "duration": i % 3} for i in range(40)]
    _write(tmp_path / "x.tsv", rows)
    tm, jdf = t_man.load_manifests(str(tmp_path)), j_man.load_manifests(str(tmp_path))
    assert t_man.durations(tm).dtype == jdf["duration"].dtype == np.int64
    assert t_man.ordered_indices(tm) == [int(i) for i in j_man.ordered_indices(jdf)]
    with pytest.raises(FileNotFoundError):
        t_man.load_manifests(str(tmp_path / "nothing"))
    with pytest.raises(ValueError):
        t_man.split_dataframe(tm, "bogus")


def _assert_batches_equal(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        for k in ("ori_caption", "struct_caption", "names"):
            assert g[k] == w[k], k
        np.testing.assert_array_equal(g["mel"], w["mel"])


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_dataset_items_match_jax(data_dir, drop):
    """Every item of the train split: mel (the pad-value mel for the file
    that fails to load), captions (an empty caption synthesized, an empty
    ori_cap printed as pandas prints NaN), the dropout draws."""
    jd = j_ds.SpecDataset("train", data_dir, mel_num=8, drop=drop, seed=3)
    td = t_ds.SpecDataset("train", data_dir, mel_num=8, drop=drop, seed=3)
    assert len(td) == len(jd) == 60
    for i in range(len(td)):
        g, w = td[i], jd[i]
        assert (g.ori_caption, g.struct_caption, g.name) == (w.ori_caption, w.struct_caption,
                                                              w.name)
        np.testing.assert_array_equal(g.mel, w.mel)
    assert any(td[i].ori_caption == "nan" for i in range(len(td))) or drop
    other_t = t_ds.SpecDataset("all", os.path.join(data_dir, "other"), mel_num=8,
                               synthesize_struct=True)
    other_j = j_ds.SpecDataset("all", os.path.join(data_dir, "other"), mel_num=8,
                               synthesize_struct=True)
    assert [other_t[i].struct_caption for i in range(45)] == \
        [other_j[i].struct_caption for i in range(45)]


def test_loader_shards_match_jax_over_two_epochs(data_dir):
    """Ranks 0 and 1 of 2, shuffled, epochs 0 and 1: the same batches in the
    same order as JAX's; the shards are disjoint and cover the split."""
    covered = []
    for rank in (0, 1):
        mk = lambda m: m.BucketedBatchLoader(m.SpecDataset("train", data_dir, mel_num=8), 4,
                                             num_replicas=2, rank=rank, seed=5)
        tl, jl = mk(t_ds), mk(j_ds)
        assert tl._batches == [[int(i) for i in b] for b in jl._batches]
        covered += [i for b in tl._batches for i in b]
        for epoch in (0, 1):
            tl.set_epoch(epoch)
            jl.set_epoch(epoch)
            _assert_batches_equal(list(tl), list(jl))
    assert sorted(covered) == list(range(60))
    # unshuffled val with the reference's pad length
    mk = lambda m: m.BucketedBatchLoader(m.SpecDataset("val", data_dir, mel_num=8), 6,
                                         shuffle=False, use_bucket_lattice=False, drop_last=True)
    _assert_batches_equal(list(mk(t_ds)), list(mk(j_ds)))


def test_two_pool_loader_matches_jax(data_dir):
    def make(m, n_main):
        main = m.BucketedBatchLoader(m.SpecDataset("train", data_dir, mel_num=8), n_main, seed=2)
        other = m.BucketedBatchLoader(m.SpecDataset("all", os.path.join(data_dir, "other"),
                                                    mel_num=8, synthesize_struct=True), 4, seed=2)
        return m.TwoPoolBatchLoader(main, other)

    for n_main in (4, 2):  # other pool larger, then smaller than the main pool
        tl, jl = make(t_ds, n_main), make(j_ds, n_main)
        tl.set_epoch(1)
        jl.set_epoch(1)
        assert len(tl) == len(jl)
        _assert_batches_equal(list(tl), list(jl))


def test_collate_pad_and_tile_match_jax(rng):
    lens = [33, 70, 700, 1300]
    samples = [(m.SpecSample(rng.standard_normal((8, t)).astype(np.float32), "o", "s", f"n{t}"))
               for t in lens for m in (t_ds,)]
    jsamples = [j_ds.SpecSample(s.mel, s.ori_caption, s.struct_caption, s.name) for s in samples]
    for lattice in (True, False):
        _assert_batches_equal([t_ds.collate_pad(samples, use_bucket_lattice=lattice)],
                              [j_ds.collate_pad(jsamples, use_bucket_lattice=lattice)])
    for target in (32, 624):
        _assert_batches_equal([t_ds.collate_tile(samples, target)],
                              [j_ds.collate_tile(jsamples, target)])


def test_struct_captions_match_jax():
    with open("audiocaps_test_16000_struct.tsv", newline="") as f:
        raws = [r["caption"] for r, _ in zip(csv.DictReader(f, delimiter="\t"), range(200))]
    for time_only in (False, True):
        assert t_sc.build_order_dict(time_only) == j_sc.build_order_dict(time_only)
        assert t_sc.parse_struct_captions(raws, time_only) == \
            j_sc.parse_struct_captions(raws, time_only)
