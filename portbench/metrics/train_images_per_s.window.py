"""Training images a second: every image of every training step finished in
the window, over the window's host-clock span. It follows the shared host's
load, so it stands per layer, beside the cell's bounded memory peak."""


def read(r):
    return r.images / r.window_s
