"""``python -m owl_path_tracer_tpu_torch``: read assets/settings.json and run
the configured sweep (utils/cli.py)."""
from .utils.cli import main

if __name__ == "__main__":
    main()
