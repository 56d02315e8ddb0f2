"""Traffic drivers: ``traffic/<name>.json`` names one by its ``driver``
key, and the harness imports ``drivers/<driver>.py``. Each has a
``Session(ctx)`` with ``setup()``, ``window()``, ``judged()`` and
``close()`` (``harness.main`` says what each returns)."""
