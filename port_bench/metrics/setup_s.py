"""Seconds from the harness's first line to the end of the cell's set-up:
imports, the kernel libraries, weights and inputs made from the seed, the
build of the port's function and the warm-up of the cell's shapes."""


def read(r):
    return r.setup_s
