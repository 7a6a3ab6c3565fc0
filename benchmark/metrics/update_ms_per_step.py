"""update_ms_per_step: the device stretch (ms) of the program's step.update
span per traced step: the optimizer's update (and, over a mesh, the
gradients' sum)."""


def read(rec):
    return rec.get("update_ms_per_step")
