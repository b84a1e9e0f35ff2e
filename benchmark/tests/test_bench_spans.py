"""The readers of the program's own recorder (`harness/spans.py` and the
metrics that use it), on the CPU: each reads a number in every cell it is
reported in, from a recorder filled by a run of the cell's tiny CPU
pipeline (warm requests, a window, a traced stretch, as `run.py` sends
them), and None from an empty recorder. The card's stamp ring is stood in
for by the host clock, and the batch-1 cell's graphs by host-side replays
of their captures, so that every span a reader looks for is there."""

import dataclasses
import importlib
import json
import math
import time

import pytest
import torch

from benchmark import run
from benchmark.harness import spec, traffic as traffic_mod
from benchmark.harness.rehearsal import tiny

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
READERS = [m for m in BENCH["per_layer"] if "spans" in vars(spec.load_metric(m["name"]))]
SEED = 2 ** 31 + 7


class HostStamps:
    """The card's stamp ring on the host clock: a stamp outside a capture
    runs at once, a capture's stamps run at each replay of its graph."""

    def __init__(self):
        from audiolcm_torch import obs

        self.obs, self.issued, self.head = obs, 0, 0
        self.ring = [0] * obs.RING_STAMPS

    def run(self):
        self.ring[self.head % len(self.ring)] = time.perf_counter_ns()
        self.head += 1

    def stamp(self):
        if self.obs._capture is None:
            self.run()
        self.issued += 1
        return self.issued - 1

    def times(self):
        return list(self.ring)


def host_graph(pipe, batch: int, latent: int, tok: int, stamps):
    """`aot.CapturedGenerate` on the CPU: its generate recorded under
    `obs.capture`, and a replay that runs the capture's stamps."""
    from audiolcm_torch import aot, obs

    g = object.__new__(aot.CapturedGenerate)
    g.pipeline, g.latent_len = pipe, latent
    g.clap_ids = torch.zeros((batch, tok), dtype=torch.int64)
    g.t5_ids = torch.zeros((batch, tok), dtype=torch.int64)
    g.shape = (batch, latent, pipe.modules.dit.in_channels)
    g.x_T, g.noise = torch.zeros(g.shape), torch.zeros((1,) + g.shape)
    with obs.capture(pipe.device) as g.tally:
        g.wav, g.mel = g._run()
    g.graph = type("HostGraph", (), {"replay": lambda self: [
        stamps.run() for _ in range(g.tally.n_stamps)]})()
    return g


@pytest.fixture(scope="module")
def filled():
    """{cell: (Readings of a tiny CPU run, the recorder's snapshot after it)},
    and the snapshot of an empty recorder under None."""
    from audiolcm_torch import obs

    saved = obs._stamps_for
    stamps = HostStamps()
    obs._stamps_for = lambda device: stamps
    out = {}
    try:
        for cell_name in sorted({c for m in READERS for c in m["workloads"]}):
            obs.reset()
            cell = spec.load_cell(cell_name)
            cell.config, cell.traffic = tiny(cell.config, cell.traffic)
            mix = cell.traffic
            driver = importlib.import_module(f"benchmark.drivers.{mix['driver']}").Driver(
                cell, SEED, torch.device("cpu"))
            mels = sorted(set(mix["mel_lens"]))
            warm = [dataclasses.replace(traffic_mod.request(mix, cell.config, SEED, -1 - i),
                                        mel_len=m) for i, m in enumerate(mels)]
            driver.setup(warm)
            if cell_name == "lcm_b1_mixdur":  # the serving graphs, replayed on the host
                for m in mels:
                    g = host_graph(driver.pipe, mix["batch"], m // 2, mix["tokens"], stamps)
                    driver.pipe._graphs[g.key] = g
            reqs = traffic_mod.requests(mix, cell.config, SEED)
            n_window = 4 if cell_name == "lcm_b1_mixdur" else 2
            records = [(r, 0.1) for r in (next(reqs) for _ in range(n_window))]
            for r, _ in records:
                driver.run(r)
            traced = [next(reqs)]
            driver.run(traced[0])
            out[cell_name] = (run.Readings(cell.config, mix, 1.0, 1.0, records, [],
                                           traced=traced), obs.snapshot())
        obs.reset()
        out[None] = obs.snapshot()
        yield out
    finally:
        obs._stamps_for = saved
        obs.reset()


@pytest.mark.parametrize("metric", READERS, ids=lambda m: m["name"])
def test_reader_reads_a_number_from_a_filled_recorder_and_none_from_an_empty_one(
        filled, metric, monkeypatch):
    from benchmark.harness import spans

    reader = spec.load_metric(metric["name"])
    for cell in metric["workloads"]:
        r, snap = filled[cell]
        monkeypatch.setattr(spans, "snapshot", lambda: snap)
        value = reader.read(r)
        assert isinstance(value, (int, float)) and math.isfinite(value) and value >= 0, \
            (metric["name"], cell, value)
        for empty in (filled[None], None):  # nothing recorded; a program without obs
            monkeypatch.setattr(spans, "snapshot", lambda: empty)
            assert reader.read(r) is None


def test_window_is_the_run_of_requests_before_the_traced_stretch(filled):
    from benchmark.harness import spans

    r, snap = filled["lcm_b1_mixdur"]
    reqs = spans.window(r, snap)
    assert [q for q, _, _ in reqs] == [q for q, _ in r.records]
    assert all(root["kind"] == "replay" for _, root, _ in reqs)
    assert spans.window(dataclasses.replace(r, traced=r.traced * 5), snap) is None
