"""lsfa_tpu_torch — LSFA streaming video object detection in PyTorch + CUDA.

The PyTorch counterpart of ``lsfa_tpu``, for NVIDIA Hopper cards. It never
imports JAX or ``lsfa_tpu``; its tests hold each module against the JAX
package on the same inputs and weights (``convert.flax_to_torch``). The one
Pallas TPU kernel of ``lsfa_tpu`` (the NMS fixpoint) is a CUDA kernel here
(``csrc/nms_sweep.cu``), built on first use on a CUDA device.
"""
