"""The quality and measurement tools (counterparts of the JAX package's
scripts/): synthetic splits, the model-free AP ceiling, evaluation of a
saved checkpoint, the oracle-box probe, the quality matrix and the
dense sweep; a training step's profile, a trace's summary, the
roofline, the serving benchmarks, the importer's check of a torchvision
file and three studies of the card (the stem, RoIAlign, NMS). Each runs
as `python -m livecell_tpu_torch.tools.<name>`."""
