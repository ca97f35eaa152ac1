"""PyTorch/CUDA port of livecell_tpu: the custom Mask R-CNN serving path
on an NVIDIA H100, with hand-written RoIAlign kernels (csrc/).

Module names mirror the JAX package's, so each module's counterpart is
found under the same path in `livecell_tpu/`. The port imports torch and
numpy, never JAX or the JAX package.
"""

from livecell_tpu_torch.ops import launch_log as _launch_log

_launch_log.install()
