"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  Every
configuration, traffic mix, cell and metric is a file of its own, found by
the name ``BENCHMARK.json`` gives it (``harness/catalog.py``)."""
