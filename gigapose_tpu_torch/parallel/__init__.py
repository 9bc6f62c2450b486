"""Multi-device runs: the launch contract and process helpers (multihost), the view-sharded template store (sharded_store), the JAX mesh helpers that keep a meaning here (mesh)."""
