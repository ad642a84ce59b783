"""The benchmark of ``dexbotic_tpu_torch``: one command runs one cell once.

    python3 -m vlabench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``vlabench/README.md``.  Importing this package imports neither torch
nor the program.
"""
