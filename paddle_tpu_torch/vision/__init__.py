"""Vision surface of the port (counterpart of paddle_tpu/vision): the
model zoo (`vision.models`, every model the JAX package's exports) and the
detection ops (`vision.ops`). `transforms` and `datasets` come with `io`
(ROADMAP Queue 1)."""
from . import models, ops
from .models import *  # noqa: F401,F403
from .models import __all__ as _models_all

__all__ = ["models", "ops", *_models_all]
