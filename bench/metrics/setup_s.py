"""setup_s: seconds from the process's start to the window's opening:
imports, the kernels' build or load, the weights' draw, the engine, the
warm-up of every shape the mix uses and, in a closed loop, the admission
of every client's first request."""


def read(rec):
    return rec.setup_s
