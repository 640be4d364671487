"""The benchmark of the PyTorch and CUDA port (tpuqcd_torch) on one card:
``python3 -m qcdbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  See PERF.md at the repository's root."""
