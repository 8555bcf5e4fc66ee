"""``idle_ms.step.recover.pool1``: device-idle milliseconds a recovery step
that overlap the program's ``fspt.recover.step`` span: the part of
``device_idle.recover.pool1`` that the step's own code holds, the rest
being outside the step (the loss read).  Layer: the device."""

from benchmark.harness import spans


def read(reading):
    return spans.idle_ms(reading, "fspt.recover.step")
