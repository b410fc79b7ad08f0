"""mc_slam_tpu_torch: the PyTorch / CUDA port of mc_slam_tpu for NVIDIA Hopper.

The JAX package `mc_slam_tpu` stays the reference; this package mirrors its
layout and names (`mc_slam_tpu_torch/frontend/matching.py` is the port of
`mc_slam_tpu/frontend/matching.py`, and so on). It imports torch and numpy,
never jax and never mc_slam_tpu.

Functions take tensors and work on the device of their inputs. Constructors
that take `device=None` build on the card (`device.resolve`): the CPU is used
only when the caller asks for it. The one hand-written kernel, the windowed
Hamming top-2 projection search of tracking, lives in
`frontend/match_cuda.py` + `csrc/hamming_top2_windowed.cu`.
"""

import torch as _torch

# Parity mode: estimation math (Lie algebra, LM normal equations, Schur
# complements) needs true float32 products, as mc_slam_tpu/__init__.py sets
# jax_default_matmul_precision=highest. TF32 keeps ~3 decimal digits and
# breaks rotation orthonormality the same way bf16 MXU passes do.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
