"""fwd_ms_per_step: the device stretch (ms) of the program's step.forward
span per traced step: the loss (treeNet's, or the joint step's render and
tree branches)."""


def read(rec):
    return rec.get("fwd_ms_per_step")
