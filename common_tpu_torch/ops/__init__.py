"""Hand-written Hopper kernels (`csrc/`) with their plain PyTorch versions.

Each wrapper launches its CUDA kernel for a CUDA tensor and takes the plain
version only for a tensor that lies on the CPU; any other device raises.
Importing a module here builds nothing: `_build.library()` compiles
`csrc/` with nvcc at the first launch.
"""

from common_tpu_torch.ops.gaussian_assign import fused_gaussian_assign  # noqa: F401
