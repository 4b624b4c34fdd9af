"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
(a model configuration under a traffic mix) run once by ``run.py``.

Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``driver`` names ``drivers/<driver>.py``),
``limits/<cell>.json`` and one reader ``metrics/<metric>.py`` per
per-layer metric of ``BENCHMARK.json``. The yardstick (``costs``,
``reference``, ``weights``, ``tracing``, ``checks``) lives here too, so a
change to the program cannot change what is measured or what counts as
correct.
"""
