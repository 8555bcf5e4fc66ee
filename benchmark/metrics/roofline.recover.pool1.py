"""``roofline.recover.pool1``: the least time the card could take for the
traced recovery steps' work (benchmark/harness/workcount.py: both buffers'
segments against every row, the reverse sweep where a field moves geometry,
the target) over the device time those steps took, in percent.  Layer: the
kernels."""


def read(reading):
    return reading.roofline_share()
