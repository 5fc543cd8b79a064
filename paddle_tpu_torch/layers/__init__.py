"""The layers (counterpart of ``paddle_tpu/layers``).  Importing the
package installs the ``Variable`` operators (``math_op_patch``), as the
JAX package does."""

from . import (cnn, control_flow, detection, io,  # noqa: F401
               layer_function_generator, learning_rate_scheduler,
               math_op_patch, metric_op, nn, ops, sequence, tensor)
from .cnn import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .layer_function_generator import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

math_op_patch.monkey_patch_variable()
