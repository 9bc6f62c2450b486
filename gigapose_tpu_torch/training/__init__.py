"""Training of the AE and IST nets: state and step, validation, checkpoints,
the loop (port of gigapose_tpu/training)."""
