"""``device.idle_share.infer``: the share of the traced window of layer-wise
passes in which no operation ran on the card, on any stream (1 - the union
of device intervals over the window), in percent."""


def read(rec):
    tr = rec.get("trace")
    return None if tr is None else tr.idle_share()
