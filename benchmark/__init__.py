"""The benchmark of psla_tpu_torch on the H100: one command runs one cell
once (``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``); ``BENCHMARK.json`` at the repository's root names the
cells, configurations and metrics, each found here by its name."""
