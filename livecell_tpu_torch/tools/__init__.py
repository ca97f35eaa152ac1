"""The quality tools (counterparts of the JAX package's scripts/):
synthetic splits, the model-free AP ceiling, evaluation of a saved
checkpoint, the oracle-box probe, the quality matrix and the dense
sweep. Each runs as `python -m livecell_tpu_torch.tools.<name>`."""
