"""The benchmark of agatha_tpu_torch: BENCHMARK.json's cells, run one at a
time by `benchmark/run.py`, with the plain reference that decides each
run's `correct`."""
