"""Scene-side models: materials, camera, compiled scene."""
