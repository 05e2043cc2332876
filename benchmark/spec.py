"""What a cell is made of, found by name: BENCHMARK.json at the root of
the checkout names each cell's configuration and traffic mix; the files
are benchmark/configs/<config>.json, benchmark/traffic/<traffic>.json,
benchmark/limits/<cell>.json (the limits that decide `correct`) and, for
each per-layer metric, benchmark/metrics/<name before the first dot>.py.
A later cell, mix or metric is a new file and a new entry, never an edit.
"""

import dataclasses
import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark_doc(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One entry of `workloads` with its files read."""

    name: str
    chips: int
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    limits: dict        # limits/<cell>.json
    end_to_end: list    # the end-to-end metric entries this cell reports
    per_layer: list     # the per-layer metric entries this cell reports


def _reports(metric, cell_name, end_to_end_names):
    """Whether `metric` (an entry of end_to_end or per_layer) belongs to
    the cell: by its `workloads` list, or else by the end-to-end metric it
    moves being one the cell reports."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in end_to_end_names
    return True


def cell(name, doc=None, here=HERE):
    """The cell called `name` in BENCHMARK.json, with its files."""
    doc = doc if doc is not None else benchmark_doc(Path(here).parent)
    found = [w for w in doc["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{[w['name'] for w in doc['workloads']]}")
    w = found[0]
    conf = [c for c in doc["configs"] if c["name"] == w["config"]][0]
    return assemble(name, w["chips"], conf["file"], w["traffic"], doc, here)


def assemble(name, chips, config_file, traffic_name, doc, here=HERE):
    """A cell from its files: the configuration file (a path from the
    checkout's root), traffic/<traffic_name>.json, limits/<name>.json, and
    the metrics of `doc` that the cell reports."""
    e2e = [m for m in doc["end_to_end"] if _reports(m, name, ())]
    names = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=chips,
        config=load_json(Path(here).parent / config_file),
        traffic=load_json(Path(here) / "traffic" / f"{traffic_name}.json"),
        limits=load_json(Path(here) / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=[m for m in doc["per_layer"] if _reports(m, name, names)])


def metric_reader(name, here=HERE):
    """The reader of per-layer metric `name`: the `read(ctx)` function of
    benchmark/metrics/<name up to its first dot>.py. The suffix names the
    end-to-end metric it moves; the reader gets it as ctx["moves"]."""
    base = name.split(".")[0]
    path = Path(here) / "metrics" / f"{base}.py"
    if not path.exists():
        raise KeyError(f"no reader for per-layer metric {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{base}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _tuples(x):
    """JSON lists back to the tuples the frozen configuration holds."""
    if isinstance(x, list):
        return tuple(_tuples(v) for v in x)
    return x


def build_dataclass(cls, values):
    """cls(**values), nested dataclass fields built from their dicts."""
    kw = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for key, v in values.items():
        if key not in hints:
            raise KeyError(f"{cls.__name__} has no field {key!r}")
        default = getattr(cls(), key) if _has_defaults(cls) else None
        if isinstance(v, dict) and dataclasses.is_dataclass(default):
            kw[key] = build_dataclass(type(default), v)
        else:
            kw[key] = _tuples(v)
    return cls(**kw)


def _has_defaults(cls):
    return all(f.default is not dataclasses.MISSING or f.default_factory is not dataclasses.MISSING
               for f in dataclasses.fields(cls))


def vio_config(config_module, doc):
    """The configuration file's `vio` group as `config_module`.VIOConfig
    (the program's module or the reference's: both hold the same fields)."""
    return build_dataclass(config_module.VIOConfig, doc["vio"])
