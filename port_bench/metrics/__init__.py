"""One reader per metric, ``<metric>.py``, with ``read(run) -> float |
None`` and its ``LAYER``, ``UNIT``, ``SOURCE`` and ``MOVES``; the harness
loads each by its file name."""
