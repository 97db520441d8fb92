"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once on the card it is started on and prints one JSON
line. Everything the harness runs is found by name under this folder:
``configs/<config>.json``, ``workloads/<cell>.json``, ``end_to_end/<metric>
.json``, ``metrics/<metric>.py``, ``drivers/<driver>.py``,
``reference/<family>.py`` and ``costs/``. ``python bench/describe.py``
lists what it finds as ``BENCHMARK.json``.
"""
