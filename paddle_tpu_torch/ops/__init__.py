"""The op namespace (port of ``paddle_tpu/ops``): free functions with
paddle's signatures over ``torch.Tensor``, re-exported at the package's
top level (``paddle_tpu_torch.reshape(x, [2, -1])``)."""
from . import comparison, creation, linalg, manipulation, math, reduction
from .comparison import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403

__all__ = (creation.__all__ + math.__all__ + comparison.__all__ +
           reduction.__all__ + manipulation.__all__ + linalg.__all__)
