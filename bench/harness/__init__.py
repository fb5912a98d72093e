"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``bench/run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything
that belongs to one configuration, one traffic mix or one per-layer
metric is a file of its own that the harness finds by the name in
``BENCHMARK.json``: ``bench/configs/<config>.json`` (the file the
configuration's ``file`` names), ``bench/traffic/<mix>.json``, the
driver of the mix's ``kind``, ``bench/drivers/<kind>.py``, and
``bench/metrics/<metric>.py``.

Modules: ``spec`` (finding those files), ``cell`` (a run handed to its
driver, and the result line), ``data`` (the one generator of networks
and input batches), ``window`` (the timed loop of batches), ``trace``
(reducing a profiler trace), ``roofline`` (the peaks and the bytes a
forward needs), ``check`` (the comparison that decides ``correct``),
``schedule`` (open-loop arrival times, for a driver of requests that
arrive on their own).  None of them imports JAX or the JAX package, and
only ``data`` and the drivers touch the port.
"""
