"""One reader per metric, ``<name>.py`` with ``read(record) -> float | None``, found by the
metric's name in BENCHMARK.json. ``record`` is the run's record: for every run the
window's totals (``B``, ``steps``, ``window_s``, ``peak_bytes``, ``setup_s``), and in the
traced run the traced episode's (``traced_s``, ``traced_steps``, ``solve_s``,
``launches``, ``launches_by_width``, ``busy_s``, ``device_ops``) with the configuration's
roofline table (``roofline``). A reader that finds nothing to read returns None, and the
metric is left out of the line."""
