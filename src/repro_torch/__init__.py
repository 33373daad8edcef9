"""PyTorch/CUDA port of the LAMC co-clustering system.

The dense main path of the paper's Algorithm 1 (``core.lamc.lamc_cocluster``)
with hand-written Hopper kernels for the k-means step and the bipartite
normalization (``kernels``). The JAX package ``repro`` is the reference this
package is held against; nothing here imports it.
"""
