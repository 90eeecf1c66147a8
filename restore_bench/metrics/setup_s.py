"""Process start to the first timed request: data or weights made from
the seed, the program built, its kernels loaded, every shape warmed."""


def read(run):
    return run.setup_s
