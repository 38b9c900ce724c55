"""The port's benchmark: the production trainer's step on the H100.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``.  Everything a cell needs is
found by name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<cell>.json``, and by the configuration's ``model_type``
``port/<type>.py``, ``reference/<type>.py`` and ``flops/<type>.py``; each
metric is read by ``metrics/<metric>.py``.
"""
