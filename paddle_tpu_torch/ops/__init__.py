"""Op computes of the PyTorch port, registered on import (counterpart of
``paddle_tpu/ops``).  ``ops/cuda`` holds the hand-written Hopper kernels
and their plain PyTorch versions; nothing there builds or imports a GPU
toolchain until a kernel is first launched."""

from . import (activation, attention, control_flow,  # noqa: F401
               conv, creation, crf, ctc, detection, elementwise,
               fused_conv_bn, kv_cache, loss, manipulation, math, metric,
               norm, optimizer_ops, pipeline_region, pool, quantize, random,
               reduction, rnn,
               sampled_loss, selected_rows, sequence)
