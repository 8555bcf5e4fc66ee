"""``roofline.render``: the least time the card could take for the traced
frames' work (benchmark/harness/workcount.py: segments against every
primitive row, the lanes' outputs and the framebuffer) over the device time
those frames took, in percent.  Layer: the kernels."""


def read(reading):
    return reading.roofline_share()
