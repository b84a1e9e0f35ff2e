"""The harness on the CPU: its files against BENCHMARK.json, the traffic
generator, the yardstick against torch's FLOP counter over the reference,
the reference against the port, the CPU rehearsal of a run, and a run's
refusals (no card, JAX loaded)."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness import spec, traffic, work
from benchmark.harness.rehearsal import rehearse, tiny
from benchmark.reference import model
from benchmark.reference.layout import layouts

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# ----------------------------------------------------------------- the files

def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units)
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_finds_its_files():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for cell in CELLS:
        loaded = spec.load_cell(cell)
        assert loaded.check["sample"] >= 1 and loaded.check["limits"]
        assert (spec.BENCH_DIR / "drivers" / f"{loaded.traffic['driver']}.py").is_file()
        spec.load_loop(loaded.traffic)


def test_each_cell_runs_the_configuration_file_that_benchmark_json_names():
    files = {c["name"]: spec.load_json(ROOT / c["file"]) for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert spec.load_cell(w["name"]).config == files[w["config"]]


@pytest.mark.parametrize("change", [{"clients": 4}, {"clients": None}, {"loop": "open"}],
                         ids=["clients-4", "clients-unset", "loop-open"])
def test_a_mix_its_loop_does_not_run_is_refused(change):
    mix = dict(spec.load_json(spec.BENCH_DIR / "traffic" / "b1_mixdur.json"), **change)
    with pytest.raises(SystemExit):
        spec.load_loop(mix)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_declares_what_benchmark_json_says(metric):
    reader = spec.load_metric(metric["name"])
    assert reader.UNIT == metric["unit"] and reader.SOURCE == metric["source"]
    if "layer" in metric:
        assert (reader.LAYER, reader.MOVES) == (metric["layer"], metric["moves"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_the_metric_they_move(metric):
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric.get("workloads", CELLS):
        assert "workloads" not in moved or cell in moved["workloads"], (metric["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        c = spec.load_cell(cell)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer


def test_layer_names_agree_letter_for_letter():
    readers = {m["name"]: spec.load_metric(m["name"]) for m in BENCH["per_layer"]}
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(readers[m["name"]].LAYER)
    assert all(len(v) == 1 for v in by_layer.values()), by_layer


# ----------------------------------------------------------------- traffic

@pytest.mark.parametrize("mix", ["b8_10s", "b1_mixdur"])
def test_traffic_is_deterministic_from_the_seed(mix):
    t = spec.load_json(spec.BENCH_DIR / "traffic" / f"{mix}.json")
    c = spec.load_json(spec.BENCH_DIR / "configs" / "audiolcm.json")
    seed = 2 ** 31 + 12345
    a = [traffic.request(t, c, seed, i) for i in range(8)]
    b = [traffic.request(t, c, seed, i) for i in range(8)]
    assert all(torch.equal(x.clap_ids, y.clap_ids) and torch.equal(x.t5_ids, y.t5_ids)
               and x.mel_len == y.mel_len and x.draw_seed == y.draw_seed for x, y in zip(a, b))
    other = [traffic.request(t, c, seed + 1, i) for i in range(8)]
    assert not torch.equal(a[0].clap_ids, other[0].clap_ids)
    assert a[0].clap_ids.shape == (t["batch"], t["tokens"]) and a[0].clap_ids.dtype == torch.int64
    assert int(a[0].t5_ids.max()) < c["t5"]["vocab_size"]


def test_every_seed_sends_the_same_mix_of_durations():
    t = spec.load_json(spec.BENCH_DIR / "traffic" / "b1_mixdur.json")
    block = sum(t["mix"])
    want = sorted(m for m, w in zip(t["mel_lens"], t["mix"]) for _ in range(w))
    orders = set()
    for seed in (1, 2, 3, 2 ** 31 + 7):
        lens = [traffic.class_order(t, seed, i) for i in range(4 * block)]
        for k in range(4):
            assert sorted(lens[k * block:(k + 1) * block]) == want
        orders.add(tuple(lens))
    assert len(orders) > 1


# ----------------------------------------------------------------- yardstick

def _counted(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn()
    return float(counter.get_total_flops())


def _tiny_config():
    c = spec.load_json(spec.BENCH_DIR / "configs" / "audiolcm.json")
    t = spec.load_json(spec.BENCH_DIR / "traffic" / "b8_10s.json")
    return tiny(c, t)[0]


def _sds(config):
    from benchmark.harness.weights import make_state_dicts

    return make_state_dicts(config, 3, torch.device("cpu"), torch.float32)


def test_work_counts_match_the_flop_counter_over_the_reference():
    c = _tiny_config()
    sds = _sds(c)
    b, tok, latent = 2, 77, 12
    ids = torch.randint(0, 100, (b, tok))
    assert _counted(lambda: model.clap_text(sds["clap_text"], c["clap_text"], ids)) == \
        work.bert_flop(c["clap_text"], b, tok)
    assert _counted(lambda: model.t5(sds["t5"], c["t5"], ids)) == work.t5_flop(c["t5"], b, tok)
    ctx = torch.randn(b, 2 * tok, c["dit"]["context_dim"])
    x, t = torch.randn(b, latent, c["dit"]["in_channels"]), torch.full((b,), 499)
    w = model.guidance_embedding(torch.full((b,), 4.0))
    assert _counted(lambda: model.dit(sds["dit"], c["dit"], x, t, ctx, w)) == \
        work.dit_flop(c["dit"], b, latent, 2 * tok, True)
    z = torch.randn(b, latent, c["vae"]["embed_dim"])
    assert _counted(lambda: model.vae_decode(sds["vae"], c["vae"], z)) == \
        work.vae_decode_flop(c["vae"], b, latent)
    # the up filter's transposed conv also runs over its 2 x 5 replicate-padded
    # samples, which the yardstick does not count as the model's work
    mel = torch.randn(b, 2 * latent, 80)
    counted = _counted(lambda: model.vocoder(sds["vocoder"], c["vocoder"], mel))
    pad_macs = sum(2 * 5 * 12 * ch * (18 if i < 6 else 1) for i, (ch, _) in enumerate(
        work.vocoder_stages(c["vocoder"], 2 * latent) + [(3, 0)]))
    assert counted == work.vocoder_flop(c["vocoder"], b, 2 * latent) + 2 * b * pad_macs


def test_k1_and_k3_bounds_by_hand():
    c = spec.load_json(spec.BENCH_DIR / "configs" / "audiolcm.json")
    # C=48 at T=79 872 and C=24 at T=159 744, batch 8: operation-bound
    flop48 = (252 * 48 * 48 + 18 * 60 * 48) * 8 * 79872
    flop24 = (252 * 24 * 24 + 18 * 60 * 24) * 8 * 159744
    assert work.fused_stages_bound_s(c, 8, 624) == pytest.approx((flop48 + flop24) / 989e12)
    teacher = spec.load_json(spec.BENCH_DIR / "configs" / "audiolcm_teacher.json")
    # (16, 8, 467, 72) in bf16: q, k, v, out at 34.4 MB outweigh 8.04 GFLOP
    one = max(4 * 16 * 8 * 467 * 72 * 2 / 3.35e12, 4 * 16 * 8 * 467 * 467 * 72 / 989e12)
    assert one == 4 * 16 * 8 * 467 * 72 * 2 / 3.35e12
    assert work.self_attention_bound_s(teacher, 8, 624, 77) == pytest.approx(800 * one)


# ----------------------------------------------------------------- reference vs port

@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_reference_agrees_with_the_port_in_f32(cell):
    rc, out = rehearse(cell, 2 ** 31 + 99)
    assert rc == 0 and out["rehearsal"] and out["correct"] and out["failed"] == 0
    assert "metrics" not in out
    assert all(v["value"] < 1e-4 for v in out["checks"].values()), out["checks"]


def test_reference_layout_is_what_the_port_loads():
    from benchmark.harness import program

    c = _tiny_config()
    pipe = program.build_pipeline(c, _sds(c), torch.device("cpu"))
    for name, m in pipe.modules.items():
        assert m is not None
    assert sum(len(v) for v in layouts(c).values()) > 100


# ----------------------------------------------------------------- imports and refusals

FORBIDDEN = ("jax", "jaxlib", "flax", "audiolcm_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_nothing_imports_jax_and_the_reference_imports_nothing_of_the_port():
    for path in spec.BENCH_DIR.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(FORBIDDEN), path
        if "reference" in path.parts:
            assert "audiolcm_torch" not in tops and "benchmark.harness" not in \
                {m.rsplit(".", 1)[0] for m in _imports(path)}, path


def test_a_rehearsal_loads_no_jax_module():
    """In a fresh process: after a CPU rehearsal of a run, no loaded module's
    top-level name (before the first dot, compared whole) is JAX's or the
    JAX package's; the port's is there."""
    probe = ("import json, sys\n"
             "from benchmark import run\n"
             "rc = run.main(['--workload', 'lcm_b8_10s', '--seed', '5', '--seconds', '0.3', "
             "'--trace', '0', '--rehearsal'])\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert not set(tops) & set(FORBIDDEN)
    assert "audiolcm_torch" in tops


def test_without_a_card_a_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "lcm_b8_10s",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch, capsys):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    rc = run.main(["--workload", "lcm_b8_10s", "--seed", "4", "--seconds", "0.3",
                   "--trace", "0", "--rehearsal"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out.strip() == "" and "jax" in captured.err
