"""The benchmark of ``super_resolution_tpu_torch`` on an NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
per-layer metric or cell's limits is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json`` (whose ``kind`` names
the driver, ``drivers/<kind>.py``), ``metrics/<metric>.py``,
``limits/<cell>.json``.  A cell on several cards runs one process per
card.
"""
