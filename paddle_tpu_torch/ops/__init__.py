"""The flat tensor-op namespace: the counterpart of `paddle_tpu/ops/`
(the `paddle.*` functions), over torch.

Inputs that are tensors stay on their device; host data (numpy arrays,
lists, Python scalars) goes to the default device (`set_device`, else
the card). Results carry the reference's values, shapes and dtypes
(x64 off: indices and integer reductions are int32). `registry` counts
the surface against the reference's op list (`reference_ops.txt`, this
package's own copy).
"""
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403

from . import creation, extras, linalg, manipulation, math  # noqa: F401
from . import registry  # noqa: F401
