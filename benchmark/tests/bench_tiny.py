"""Cells of the benchmark cut to a size the CPU tests hold: the reduced
camera, grid and window of the port's CPU tests (tests/test_torch_slice.py
`_small_config`), 2 sequences (the ESKF 1) of 16 frames."""

import copy
import dataclasses

from benchmark import spec, traffic as gen


# Cells whose files are kept but that BENCHMARK.json does not run (PERF.md,
# Open questions): (configuration, traffic).
STAGED = {"eskf.offline": ("eskf_euroc", "offline_b1")}


def full_cell(name):
    """A cell of BENCHMARK.json, or a staged one built from its files."""
    if name in STAGED:
        conf, mix = STAGED[name]
        return spec.assemble(name, 1, f"benchmark/configs/{conf}.json", mix,
                             spec.benchmark_doc())
    return spec.cell(name)


def tiny_cell(name, **traffic):
    c = full_cell(name)
    doc = copy.deepcopy(c.config)
    v = doc["vio"]
    for cam in ("cam0", "cam1"):
        fx, fy, cx, cy = v[cam]["intrinsics"]
        v[cam]["intrinsics"] = [fx / 4, fy / 4, cx / 4, cy / 4]
        v[cam]["resolution"] = [188, 120]
    v["frontend"].update(grid_row=2, grid_col=2, max_tracks=32, lk_pyramid_levels=2)
    v["filter"].update(max_cam_state_size=6, max_features=32, max_lost_candidates=16)
    if "eskf" in doc:
        doc["eskf"].update(grid_row=2, grid_col=2)
    tr = copy.deepcopy(c.traffic)
    n = 1 if doc["pipeline"] == "eskf" else 2
    tr.update(frames=16, chunk=4, warmup_frames=4, trace_steps=2,
              check=dict(first_frames=4, spans=2, span_frames=3))
    tr["streams" if tr["loop"] == "live" else "sequences"] = n
    tr.update(traffic)
    c.config, c.traffic = doc, tr
    return c


def move_from_the_first_frame(monkeypatch):
    """Sequences that move from their first frame (the cells' start with
    0.5 s at rest), so that short spans see them move: the generator's
    SimConfig with the static start as long as the filter's initialisation."""
    made = gen.sim_config

    def sim_config(*a, **kw):
        return dataclasses.replace(made(*a, **kw), static_init_time=1.0)

    monkeypatch.setattr(gen, "sim_config", sim_config)
