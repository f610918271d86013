"""``paddle.vision`` (port of ``paddle_tpu/vision``): the ResNet family so
far. ``transforms``, ``datasets``, ``ops`` and the other model families
(``vision/models/small.py``, ``extra.py``) are not ported yet (ROADMAP
Queue 1)."""
from . import models  # noqa: F401
