"""The benchmark of owl_path_tracer_tpu_torch on one NVIDIA GPU (``run.py``)."""
