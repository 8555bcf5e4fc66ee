"""``device_idle.recover.pool1``: the share of the traced recovery steps'
window in which no operation ran on the device, in percent.  Layer: the
device."""


def read(reading):
    return reading.idle_share()
