"""Command-line tools of the port (counterparts of the repository's
``bench.py`` and ``tools/`` scripts): the throughput bench, the
retirement-loop latency probe, checkpointed production rendering, the
gallery, the multi-rank load-balance and scaling measurements, and the
sharded renderers' communication model.  Run them as modules, e.g.
``python -m owl_path_tracer_tpu_torch.tools.bench``."""
