"""``host_ms.grad.recover.pool1``: host milliseconds a recovery step inside
the program's ``fspt.recover.grad`` span, the loss-and-gradient call (its
host prelude and launches).  Layer: the kernels, the gradient call's host
side."""

from benchmark.harness import spans


def read(reading):
    return spans.host_ms(reading, "fspt.recover.grad")
