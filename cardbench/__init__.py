"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one run of
one cell is ``python3 cardbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout."""
