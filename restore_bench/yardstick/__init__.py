"""Frozen copies of what the benchmark measures with: table and traffic
generators, the H100's peaks and each kernel's operations and bytes.
Nothing here imports the program."""
