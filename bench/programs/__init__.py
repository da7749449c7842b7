"""How the harness drives the port, one module a model family.

A module here takes a configuration file's dict and gives the harness the
port's configuration object (``arch``), the parameter tree drawn on the
device from the seed (``draw_params``), the input pools (``draw_pools``),
one request's batch (``batch``) and the timed entry (``run``).  It is the
only part of the benchmark that imports ``repro_torch``.
"""
