"""Traffic drivers, one per kind of entry point of the program.  A
config file names its driver; each module defines ``Driver``."""
