"""SPFresh on PyTorch and CUDA: the single-device LIRE index (build,
search, insert, delete) with hand-written Hopper kernels for centroid
navigation and the paged posting scan.  Imports no JAX."""
