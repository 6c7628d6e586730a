"""The benchmark of ising_tpu_torch on NVIDIA GPUs.

    python3 -m isingbench.run --workload NAME --seed N --seconds S --trace 0|1

BENCHMARK.json, at the root of the checkout, names each cell: a
configuration (configs/<name>.json) under a traffic mix
(traffic/<name>.json), and the metrics, each read by metrics/<name>.py.
"""
