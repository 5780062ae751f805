"""setup_s: process start to the window's start (host clock): imports, the
kernel library's load (its build on a checkout's first run), the inputs,
the set-up factorization where the traffic has one, the warm-up system."""


def read(run):
    return run.setup_s
