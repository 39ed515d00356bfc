"""Command-line tools of the port (counterparts of the repository's
``tools/`` scripts): the retirement-loop latency probe and checkpointed
production rendering.  Run them as modules, e.g.
``python -m owl_path_tracer_tpu_torch.tools.latency_probe``."""
