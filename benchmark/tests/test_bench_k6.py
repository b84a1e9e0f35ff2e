"""K6's readers on the CPU: the roofline's FLOP by hand at the served
shapes, and None where the trace holds no K6 kernel (a parent without it)."""

import json
import types
from pathlib import Path

import pytest

from benchmark.harness import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _trace(ops):
    """What the reader takes of a trace: device seconds by kernel name."""
    return types.SimpleNamespace(
        seconds_of=lambda *subs: sum(s for n, s in ops if any(x in n for x in subs)))


@pytest.mark.parametrize("cell", ["lcm_b8_10s", "teacher_b8_ddim100"])
def test_k6_roofline_counts_252_c2_bt_over_the_unfused_stages(cell):
    reader = spec.load_metric("k6_roofline")
    config = spec.load_cell(cell).config
    want = 252 * 8 * (768 ** 2 * 2496 + 384 ** 2 * 9984 + 192 ** 2 * 19968 + 96 ** 2 * 39936)
    assert reader.convs_flop(config, 8, 624) == want
    traced = [types.SimpleNamespace(batch=8, mel_len=624)] * 3
    r = types.SimpleNamespace(config=config, traced=traced,
                              trace=_trace([("void wide_conv_kernel<192>(...)", 0.030),
                                            ("implicit_convolve_sgemm", 1.0)]))
    assert reader.read(r) == pytest.approx(100 * 3 * want / 989e12 / 0.030)
    r.trace = _trace([("implicit_convolve_sgemm", 1.0)])
    assert reader.read(r) is None
    r.trace = None
    assert reader.read(r) is None


def test_k6_entries_list_the_cells_that_report_what_they_move():
    entries = {m["name"]: m for m in BENCH["per_layer"] if m["name"].startswith("k6_")}
    assert set(entries) == {"k6_launches", "k6_launches.b1", "k6_roofline"}
    assert entries["k6_launches.b1"]["workloads"] == ["lcm_b1_mixdur"]
    assert entries["k6_roofline"]["workloads"] == ["lcm_b8_10s", "teacher_b8_ddim100"]
