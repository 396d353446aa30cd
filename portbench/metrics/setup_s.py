"""Seconds from the process's start to the first timed unit being ready."""


def read(r):
    return r.setup_s
