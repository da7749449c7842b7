"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on the card it finds and
prints one JSON line.  Everything that belongs to one configuration, one
traffic mix, one cell or one per-layer metric is a file of its own that
the harness finds by the name in ``BENCHMARK.json``:

* ``configs/<config>.json``: the sizes as run, their source, the cut, and
  the names of the modules below that serve this configuration;
* ``traffic/<mix>.json``: the parameters that :mod:`bench.traffic` turns
  into a request schedule;
* ``cells/<cell>.json``: what the output check samples and its limits;
* ``programs/<family>.py``: how the port is driven (weights, inputs, the
  entry it calls); ``reference/<family>.py``: the plain PyTorch forward
  that ``correct`` is judged against; ``flops/<family>.py``: the frozen
  operation and byte counts;
* ``metrics/<metric>.py``: one reader for each per-layer metric.

Nothing here imports ``jax`` or the JAX package ``repro``; the reference
and the counts import nothing of ``repro_torch`` either.
"""
