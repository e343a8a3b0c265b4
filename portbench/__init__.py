"""The benchmark of ``raytracer_js_tpu_torch``: ``run.py`` runs one cell of
``BENCHMARK.json`` once (see ``harness``)."""
