"""Hand-written Hopper kernels of the port, their plain versions and dispatch.

``ops`` is the public surface; ``ref`` holds the plain PyTorch versions;
``csrc/`` the CUDA C++ sources, built by ``_build`` at first use.
"""
