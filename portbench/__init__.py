"""The benchmark of the PyTorch and CUDA port (``BENCHMARK.json``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; ``README.md`` says how to add a cell,
a configuration or a metric.  Importing the package starts nothing.
"""
