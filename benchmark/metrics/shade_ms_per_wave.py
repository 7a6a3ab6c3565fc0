"""shade_ms_per_wave: the device time (ms) per traced wave of the Path
wave's shading stages: the self stretches (each less its children's, so the
traversal, the re-sort and the host reads drop out) of the program's spans
wave.tables, wave.camera, bounce.emission, bounce.material, bounce.light,
bounce.bsdf, wave.tail and wave.film (harness/spans.py); the mean over the
ranks where sharded."""


def read(rec):
    return rec.get("shade_ms_per_wave")
