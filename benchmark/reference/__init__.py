"""The plain reference renderer: float32 PyTorch, TF32 off, no kernel and
nothing of the program.  It renders a configuration's pass again from the
scene files and the seed, so the harness can judge what the timed path made.
A configuration names the module that does so under ``"reference"``
(``render`` where it names none); a module of its own may build on
``render``, ``shading``, ``traversal`` and ``rng``."""
