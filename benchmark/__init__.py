"""The benchmark of the PyTorch/CUDA port (``deftet_tpu_torch``) on an
NVIDIA H100: ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout (see
``harness.py`` for how it finds its files)."""
