"""``launches.recover.pool1``: device kernels a recovery step launches, over
the traced steps (memory copies and sets left out).  Layer: the entry, the
recovery step of ``parallel/train.make_fused_recovery_step``."""


def read(reading):
    return reading.launches()
