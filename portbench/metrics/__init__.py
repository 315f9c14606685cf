"""One reader per per-layer metric, ``<metric>.py`` with
``read(run) -> float | None``: None where the run holds nothing to read.

``run`` is a dict: the driver's ``records`` (``units`` of a clips run,
each with ``frames_n``, ``padded``, ``io_s``, ``stages``; ``steps`` of a
train run; ``window_s``; ``work`` from ``counts/``), ``trace``
(``profiling.summarize``), ``peak_bytes``, ``config`` and ``traffic``."""
