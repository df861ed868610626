"""shufflebench: the benchmark of the port, ``sparkrdma_tpu_torch``.

One command runs one cell once (see ``README.md``):

    python3 -m shufflebench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Importing this package imports neither the program nor torch.
"""
