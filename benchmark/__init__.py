"""The benchmark of ``apnerf_torch`` (``python3 -m benchmark.run``): the
cells of ``BENCHMARK.json``, their scene, traffic, reference and metric
readers. It imports neither JAX nor the JAX package ``apnerf``, and its
reference nothing of ``apnerf_torch``."""
