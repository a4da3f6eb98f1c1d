"""The distributed layer: the sharded index and its read replicas."""
