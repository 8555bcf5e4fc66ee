"""``host_ms.trace.render.heightfield``: host milliseconds a mesh frame
inside the program's ``fspt.trace`` span, the camera tracer's call (its
tables, ``PathParams`` and ``CamParams``, the output tensors, the launch
and the segment sum).  Layer: the kernels, the tracer's host call."""

from benchmark.harness import spans


def read(reading):
    return spans.host_ms(reading, "fspt.trace")
