"""Ops of the port: kernel wrappers with their plain versions
(``stem``, ``ivf_probe``), plain-torch ``normalize`` and ``kmeans``, and
the kernel build (``_build``)."""
