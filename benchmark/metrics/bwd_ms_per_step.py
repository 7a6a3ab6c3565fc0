"""bwd_ms_per_step: the device stretch (ms) of the program's step.backward
span per traced step: loss.backward or autograd.grad."""


def read(rec):
    return rec.get("bwd_ms_per_step")
