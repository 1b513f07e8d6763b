"""The benchmark of ``dvo_slam_tpu_torch`` (``BENCHMARK.json`` at the
repository root): its traffic generator, entry adapters, metric readers,
roofline arithmetic and the plain references that decide ``correct``.  It
never imports JAX or the JAX package; only the entry adapters, and the
harness's set-up, import the program."""
