"""What a run reads: BENCHMARK.json and the files it names.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by its name:

    BENCHMARK.json configs[].file       sizes, knobs, source, reduced, assumed
    benchmark/traffic/<traffic>.json    the mix: driver, loop, batch, durations
    benchmark/loops/<loop>.py           how the mix's requests are sent (`check`, `run`)
    benchmark/drivers/<driver>.py       the program's path that serves them
    benchmark/workloads/<cell>.json     the cell's check: sample, limits, traced stretch
    benchmark/metrics/<metric>.py       one reader per metric (`read(readings)`)
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str):
    """The reader module of metric `name` (benchmark/metrics/<name>.py)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_loop(mix: dict):
    """The loop module that the mix names (benchmark/loops/<loop>.py), having
    checked that it runs what the mix asks for."""
    path = BENCH_DIR / "loops" / f"{mix['loop']}.py"
    if not path.is_file():
        raise SystemExit(f"no loop {mix['loop']!r}: {path.relative_to(ROOT)} does not exist")
    loop = importlib.import_module(f"benchmark.loops.{mix['loop']}")
    try:
        loop.check(mix)
    except ValueError as e:
        raise SystemExit(f"the mix is not runnable: {e}") from None
    return loop


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    check = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, check=check,
                end_to_end=[m for m in bench["end_to_end"] if _reported_in(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reported_in(m, name)])
