"""``idle_ms.trace.render``: device-idle milliseconds a frame that overlap
the program's ``fspt.trace`` span: the part of ``device_idle.render`` that
the camera tracer's host call holds.  Layer: the device."""

from benchmark.harness import spans


def read(reading):
    return spans.idle_ms(reading, "fspt.trace")
