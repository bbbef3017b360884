"""repro_torch -- the PyTorch/CUDA port of the HP-MDR reproduction.

Mirrors ``src/repro/`` module by module: each port module answers to exactly
one reference module, and the port's bitplanes, segments and wire blobs are
byte-identical to the reference's.  Importing the package loads no kernel
and needs neither ``nvcc`` nor a card; the CUDA kernels are built at first
use (``repro_torch.kernels.bitplane``).
"""
