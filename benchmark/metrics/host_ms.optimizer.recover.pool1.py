"""``host_ms.optimizer.recover.pool1``: host milliseconds a recovery step
inside the program's ``fspt.recover.optimizer`` span (the gradients handed
to the leaves, ``optimizer.step()``, the clip and the parameters handed
back).  Layer: the entry, the recovery step."""

from benchmark.harness import spans


def read(reading):
    return spans.host_ms(reading, "fspt.recover.optimizer")
