"""Command-line tools of the port (counterparts of the repository's
``tools/`` scripts): the retirement-loop latency probe, checkpointed
production rendering, the gallery, and the multi-rank load-balance and
scaling measurements.  Run them as modules, e.g.
``python -m owl_path_tracer_tpu_torch.tools.latency_probe``."""
