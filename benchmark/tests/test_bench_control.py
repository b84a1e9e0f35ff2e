"""`correct` has to come out false where it should.

- The control: the plain reference in the program's place, computed with
  fp8 operands (one precision below the configurations' bfloat16), fails a
  cell's limits: on the CPU at tiny widths, and on the card at the cell's
  own size on three seeds (`-m card`).
- The faults a generate cell can have, planted under a CPU rehearsal of a
  whole run (its look for a card skipped): one clip's output swapped with
  another's, half of the batch left out (the first half's clips returned
  for the rest), each request answered with the previous request's output
  (a graph's static buffer handed out without its clone), and one clip's
  waveform silenced with its mel intact (a vocoder fault in one slot of the
  batch, which a mean over the clips would let through).
"""

import json

import pytest
import torch

from benchmark import calibrate
from benchmark.drivers import generate
from benchmark.harness import spec
from benchmark.harness.rehearsal import rehearse, tiny

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_at_tiny_widths(cell):
    c = spec.load_cell(cell)
    c.config, c.traffic = tiny(c.config, c.traffic)
    row = calibrate.control_readings(c, 2 ** 31 + 5, torch.device("cpu"))
    assert _fails(row["control"], c.check["limits"]), row


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_at_the_cells_size(card, cell):
    c = spec.load_cell(cell)
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        row = calibrate.control_readings(c, seed, card)
        assert _fails(row["control"], c.check["limits"]), row


def _swap(wav, mel):
    if wav.shape[0] < 2:  # one clip: its waveform time-reversed
        return wav.flip(-1), mel.flip(-2)
    order = torch.arange(wav.shape[0])
    order[[0, 1]] = order[[1, 0]]
    return wav[order], mel[order.to(mel.device)]


def _half(wav, mel):
    h = wav.shape[0] // 2
    rest = wav.shape[0] - h
    return torch.cat([wav[:h], wav[:rest]]), torch.cat([mel[:h], mel[:rest]])


def _mute_one(wav, mel):
    """The first clip's waveform silent, its mel and every other clip intact."""
    wav = wav.clone()
    wav[0] = 0
    return wav, mel


FAULTS = {"swap": _swap, "half": _half, "mute_one": _mute_one}


# a batch of one has no half to leave out
CASES = [(cell, fault) for cell in CELLS for fault in ("swap", "half", "stale", "mute_one")
         if fault != "half" or spec.load_cell(cell).traffic["batch"] > 1]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_in_the_timed_path_reads_not_correct(cell, fault, monkeypatch):
    clean = generate.Driver.run
    previous = {}

    def run(self, req):
        wav, mel = clean(self, req)
        if fault == "stale":
            out, previous["out"] = previous.get("out", (wav, mel)), (wav, mel)
            return out
        return FAULTS[fault](wav, mel)

    monkeypatch.setattr(generate.Driver, "run", run)
    rc, out = rehearse(cell, 2 ** 31 + 77)
    assert rc == 0 and out["correct"] is False, out
    if fault == "mute_one":
        assert out["checks"]["wav_rel_l2_worst"]["value"] == pytest.approx(1.0), out["checks"]
        assert out["checks"]["mel_rel_l2"]["value"] < 1e-4, out["checks"]
