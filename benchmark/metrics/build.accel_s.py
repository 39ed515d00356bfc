"""Host seconds of compile_scene and make_accel, each ended by a synchronise."""


def read(r):
    if "compile_scene" not in r.spans or "make_accel" not in r.spans:
        return None
    return r.spans["compile_scene"] + r.spans["make_accel"]
