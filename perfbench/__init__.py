"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1`` runs one
cell of ``BENCHMARK.json`` once and prints its result as the last line of
standard output. Everything that belongs to one configuration, traffic mix or
per-layer metric lives in files of its own, found by the names that
``BENCHMARK.json`` uses:

* ``configs/<config>.json``: the model's sizes, their source, what was
  assumed, and the deployment it stands for;
* ``traffic/<mix>.json``: the mix's parameters, read by the general
  generator and driver that its ``driver`` key names
  (``drivers/<driver>.py``);
* ``metrics/<metric>.py``: a reader of one per-layer metric;
* ``limits/<workload>.json``: each number that decides ``correct``, with its
  limit and the readings the limit was set from;
* ``reference/families/<family>.py``: the plain float32 reference of one
  model family, which imports nothing of the program.

The harness imports the port and never ``jax`` or the JAX package.
"""
