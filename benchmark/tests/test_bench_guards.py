"""The run's guards: no JAX (by whole top-level module name), no result
without a card, no result without the program beside the benchmark."""

import json
import shutil
import subprocess
import sys

from benchmark import device, run, spec


def test_forbidden_modules_by_whole_top_level_name():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "vio_msckf_tpu",
            "vio_msckf_tpu.engine", "vio_msckf_torch", "vio_msckf_torch.engine",
            "jaxtyping", "flaxen", "vio_msckf_tpux", "numpy"]
    assert device.forbidden_modules(dict.fromkeys(mods)) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "vio_msckf_tpu",
        "vio_msckf_tpu.engine"]
    assert device.forbidden_modules({"vio_msckf_torch": None}) == []


def test_the_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys, benchmark.reference.engine, benchmark.reference.eskf, "
            "benchmark.traffic, benchmark.check; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('vio_msckf_torch', 'vio_msckf_tpu', 'jax', 'jaxlib', 'flax')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_no_result_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = run.main(["--workload", "msckf.offline.b16", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_no_result_with_only_the_benchmark_s_files(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "msckf.offline.b16",
                        "--seed", "3", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") and "correct" in json.loads(line)
                   for line in p.stdout.splitlines() if line.startswith("{"))
