"""The port's copy of ``sitewhere_tpu/core/model.py``: so far only
``new_token``, which the media service names streams with."""

from __future__ import annotations

import uuid


def new_token(prefix: str = "") -> str:
    t = uuid.uuid4().hex[:12]
    return f"{prefix}-{t}" if prefix else t
