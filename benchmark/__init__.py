"""The benchmark of vio_msckf_torch (see BENCHMARK.json and PERF.md)."""
