"""``roofline.render.textured``: the least time the card could take for the
traced textured frames' work (benchmark/harness/texwork.py: segments against
the primitive rows, the frozen texel fetches a segment at a DRAM sector
each, the lanes' outputs and the framebuffer) over the device time those
frames took, in percent: kernel 4's share of its roofline.  Layer: the
kernels."""


def read(reading):
    return reading.roofline_share()
