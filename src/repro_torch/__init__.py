"""SPFresh on PyTorch and CUDA for one NVIDIA H100: the port of the JAX
package ``repro``, module for module.  The LIRE index (build, search,
insert, delete, the maintenance round) with hand-written Hopper kernels
for centroid navigation and the paged posting scans (``kernels/``), the
serving engine and group router (``serve/``, ``core/grouping.py``),
durability and the service API (``storage/``, ``api/``), the sharded and
replicated index (``distributed/``), the model families the registry
serves and trains (two-tower retrieval, DeepFM, BERT4Rec, MIND, the five
LMs, the GAT; ``models/``, ``train/``, ``configs/``), spflint
(``analysis/``), the launchers and the dry run with its roofline on the
``meta`` device (``launch/``).  Imports no JAX."""
