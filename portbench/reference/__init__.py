"""The plain reference of the port's models: a frozen copy of the port's
plain PyTorch code (models, losses, proposals, NMS, mask ops, stitch),
with every hand-written kernel replaced by its plain float32 form and
the mesh paths left out. It imports nothing of the port, the JAX package
or JAX, so a later change to the port cannot move it. The benchmark runs
it in float32 with TF32 off (`lowp.exact`), and in emulated fp8 as the
control (`lowp.fp8`)."""
