"""Process start to the first timed pass: imports, the kernels' load or
build, the scene files, compile_scene, make_accel and the warm-up pass."""


def read(r):
    return r.setup_s
