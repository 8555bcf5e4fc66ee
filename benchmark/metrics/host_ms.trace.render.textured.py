"""``host_ms.trace.render.textured``: host milliseconds a textured frame
inside the program's ``fspt.trace`` span, kernel 4's call (its texture
pack's checks and struct, the output tensors, the launch and the segment
sum).  Layer: the kernels, the tracer's host call."""

from benchmark.harness import spans


def read(reading):
    return spans.host_ms(reading, "fspt.trace")
