"""train_mfu: the treeNet step's model FLOPs (the encoders' products,
forward times 3, harness/yardstick.py) times the window's steps per
second, over the 67 TFLOP/s float32 peak, in %."""

from harness import yardstick


def read(rec):
    if rec.get("unit") != "step" or not rec.get("window_s") or not rec.get("flops_per_step"):
        return None
    return 100.0 * rec["flops_per_step"] * rec["steps"] / rec["window_s"] / yardstick.PEAK_FLOPS
