"""``device_idle.render.heightfield``: the share of the traced mesh frames'
window in which no operation ran on the device, in percent.  Layer: the
device."""


def read(reading):
    return reading.idle_share()
