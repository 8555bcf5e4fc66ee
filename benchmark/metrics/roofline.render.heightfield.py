"""``roofline.render.heightfield``: the least time the card could take for
the traced mesh frames' work (benchmark/harness/meshwork.py: segments
against the primitive rows and at least a root-to-leaf walk and a leaf of
the mesh's tree, the lanes' outputs and the framebuffer) over the device
time those frames took, in percent.  Layer: the kernels."""


def read(reading):
    return reading.roofline_share()
