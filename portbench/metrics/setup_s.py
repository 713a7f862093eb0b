"""Seconds from the process's start to the window's: imports, CUDA start-up,
the kernel library (built on a checkout's first run), weights, the mix's
data and the warm-up."""


def read(rec):
    return rec.setup_s
