"""slambench: the end-to-end benchmark of `jetracer_orbslam2_torch` on one
CUDA device.  `python slambench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` runs one cell of `BENCHMARK.json` once."""
