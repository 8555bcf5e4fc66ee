"""``launches.render.textured``: device kernels a textured frame launches,
over the traced frames (memory copies and sets left out).  Layer: the
entry, the frame step as the CLI builds it."""


def read(reading):
    return reading.launches()
