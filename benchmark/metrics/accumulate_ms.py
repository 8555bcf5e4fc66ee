"""``accumulate_ms``: device milliseconds a frame spends in the kernels
launched under the benchmark's span around ``render.framebuffer.accumulate``.
Layer: the framebuffer."""


def read(reading):
    seconds = reading.span_device_s.get("bench.accumulate")
    if not seconds:
        return None
    return seconds * 1e3 / reading.iterations
