"""image_setup_ms: the host time (ms) of the program's image.setup span
(the sampler, the film, the light-sampler tables, the scene upload and
the traversal tables of make_wave_fn or render_sharded), the median over
the window's images; the mean over the ranks where sharded."""


def read(rec):
    return rec.get("image_setup_ms")
