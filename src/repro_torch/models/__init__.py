"""Models that serve from the index: the two-tower retrieval towers."""
