"""NPA (Nearest Partition Assignment) necessary conditions — paper §3.3.

After a split of the posting with (deleted) centroid ``A_o`` into new
centroids ``A_1, A_2``:

* Eq. (1): a vector ``v`` of the old posting must be *checked* for
  reassignment iff ``D(v, A_o) <= D(v, A_i)`` for all i in {1, 2};
* Eq. (2): a vector ``v`` of a nearby posting must be *checked* iff
  ``D(v, A_i) <= D(v, A_o)`` for some i in {1, 2}.

Both bound the candidate set; the reassignment's nearest-posting search
drops the false positives.  Batched over any leading dims: ``v (..., n,
d)``, ``old_centroid (..., d)``, ``new_centroids (..., 2, d)`` → bool
``(..., n)``.
"""
from __future__ import annotations

from repro_torch.core.distance import sql2


def _dists(v, old_centroid, new_centroids):
    d_old = sql2(v, old_centroid[..., None, :])                      # (..., n)
    d_new = sql2(v[..., :, None, :], new_centroids[..., None, :, :])  # (..., n, 2)
    return d_old, d_new


def split_old_posting_candidates(v, old_centroid, new_centroids):
    """Eq. (1): True where a vector of the split posting must be checked."""
    d_old, d_new = _dists(v, old_centroid, new_centroids)
    return (d_old[..., None] <= d_new).all(dim=-1)


def split_neighbor_candidates(v, old_centroid, new_centroids):
    """Eq. (2): True where a vector of a nearby posting must be checked."""
    d_old, d_new = _dists(v, old_centroid, new_centroids)
    return (d_new <= d_old[..., None]).any(dim=-1)
