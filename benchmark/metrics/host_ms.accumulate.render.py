"""``host_ms.accumulate.render``: host milliseconds a frame inside the
program's ``fspt.accumulate`` span, ``render.framebuffer.accumulate`` (the
Welford fold and the AOV copies).  Layer: the framebuffer."""

from benchmark.harness import spans


def read(reading):
    return spans.host_ms(reading, "fspt.accumulate")
