"""Renderers: the bounce integrator, accelerator set-up, the wavefront pool."""
