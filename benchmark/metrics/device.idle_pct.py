"""The card's idle share: the per cent of the traced window with no
kernel, copy or set on the device.  Nothing without device activity."""


def read(w):
    return None if w.trace is None else w.trace.idle_pct()
