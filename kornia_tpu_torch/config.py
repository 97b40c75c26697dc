"""The port's run-time switches (counterpart of the ``checks_enabled``
field of ``kornia_tpu/config.py``): a mutable dataclass read where it is
used, initialised from the same environment variable."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

__all__ = ["KorniaTPUTorchConfig", "kornia_tpu_config"]


@dataclass
class KorniaTPUTorchConfig:
    """checks_enabled: the shape and type checks of ``core/check.py``;
    off when ``KORNIA_TPU_CHECK_DISABLED`` is ``1`` or ``true``."""

    checks_enabled: bool = field(
        default_factory=lambda: os.environ.get(
            "KORNIA_TPU_CHECK_DISABLED", "0") not in ("1", "true"))


kornia_tpu_config = KorniaTPUTorchConfig()
