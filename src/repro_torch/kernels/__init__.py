# Hand-written CUDA kernels for Hopper (sources in ../csrc), one package
# per kernel: ops.py (checked wrapper + launch count), ref.py (the plain
# PyTorch version).  A CUDA tensor goes to the kernel, a CPU tensor to
# the plain version; build.py compiles and loads the kernels at first use.
