"""``device_idle.render.textured``: the share of the traced textured frames'
window in which no operation ran on the device, in percent.  Layer: the
device."""


def read(reading):
    return reading.idle_share()
