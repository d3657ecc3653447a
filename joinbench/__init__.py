"""Benchmark of the PyTorch + CUDA self-join (``repro_torch``).

``python3 joinbench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json``.  Everything that belongs to one
configuration, traffic mix or metric is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``.  The data generators, the traffic generator, the
work counts and the plain reference are copies kept here, so that the
program under test cannot move the yardstick.
"""
