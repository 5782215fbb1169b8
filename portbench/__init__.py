"""portbench: the benchmark of yulio_raytracer_tpu_torch on one NVIDIA H100.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once and prints one JSON line.  Cells,
configurations, traffic mixes and per-layer metrics are files found by
name (cells/, configs/, traffic/, metrics/); see spec.py.
"""
