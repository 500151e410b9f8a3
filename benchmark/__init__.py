"""The benchmark of kalman_hydra_tpu_torch on an NVIDIA H100: one command
runs one cell of BENCHMARK.json (`python3 benchmark/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`). Everything that belongs
to a configuration, a traffic mix, a per-layer metric or a stage of the
roofline sits in a file of its own under this directory, found by name."""
