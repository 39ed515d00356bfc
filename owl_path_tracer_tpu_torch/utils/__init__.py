"""Host-side helpers: scene-file parsing, OBJ and image IO, tensor bundles."""
