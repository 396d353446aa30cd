"""Adversarial images completed a second: every image of every attack batch
finished in the window, over the window's host-clock span."""


def read(r):
    return r.images / r.window_s
