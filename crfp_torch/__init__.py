"""CRFP in PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``crfp_tpu`` (JAX/Pallas), module for module: ``crfp_torch/X``
mirrors ``crfp_tpu/X``. It computes the logical math of the JAX package;
the TPU layout devices (space-to-depth operand forms) are not carried.
Per-cell anchored HR windows are math and are carried for inference
(``ModelConfig.dcn_anchor``, ``crfp_torch.ops.anchor``), and so is the
fused-prep DCN: kernel E, behind ``ModelConfig.dcn_fused``.

Public entry points take and return NHWC tensors like the JAX models;
inside, tensors are NCHW. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``. Three paths are ported: the v18 streaming runtime
(``CRFPRuntimeV18``), the training step (the batch trunk ``CRFP`` with
``crfp_torch.train``) and evaluation (``StreamingRunner``, ``eval/``, the
deployment quality gate). The batch trunk takes every variant of the JAX
trunk (v13, v15, v18, v18_cra, no_dcn, basic_fvsr; ``hr_dcn``,
``y_only``) and either flow net (FNet, SPyNet). The other models of the
JAX package run too, inference only: the runtime variants
(``CRFPRuntimeSimple`` for v13/v15, ``CRFPRuntimeV18(nofv=True)``), the
first-generation pyramids (``CRFPPyramidX8``, ``CRFPPyramidX4``, plain or
CRA) with their ``PyramidLevelAlign``, ``nn.pcd.PCDAlign`` and the
flow-warp evaluation (``eval.flow_warp_eval``). The kernels live in
``crfp_torch/csrc`` and are built with
``nvcc`` at first use (``crfp_torch.ops.cuda``); the DCN and warp
dispatchers are autograd Functions whose backward is a kernel too. On CPU
tensors every op runs its plain PyTorch version.

Parallelism (``crfp_torch.parallel``): data-parallel training over
``torch.distributed`` ranks (``initialize_distributed``,
``data_parallel_mesh``, ``shard_batch``, ``replicate`` and
``make_train_step(model, cfg, group)``; ``python -m crfp_torch.main
--num_gpu N``), and height-sharded streaming inference
(``SpatialStreamingRunner``, ``halo_exchange``, ``sharded_conv3x3``).
"""

from crfp_torch.models.config import ModelConfig
from crfp_torch.models.crfp import CRFP
from crfp_torch.models.pyramid import CRFPPyramidX4, CRFPPyramidX8
from crfp_torch.models.runtime import CRFPRuntimeSimple, CRFPRuntimeV18

__all__ = ["ModelConfig", "CRFP", "CRFPRuntimeV18", "CRFPRuntimeSimple", "CRFPPyramidX8",
           "CRFPPyramidX4"]
