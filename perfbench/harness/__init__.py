"""The harness of the port's benchmark: one run of one cell, found by name
in ``BENCHMARK.json``. Per-cell pieces are data or code of their own:
``configs/<config>.json``, ``traffic/<traffic>.json`` (naming its driver,
``drivers/<driver>.py``), ``metrics/<metric>.py`` and
``limits/<cell>.json``."""
