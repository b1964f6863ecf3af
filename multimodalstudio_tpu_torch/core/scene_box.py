"""Scene region-of-interest description (JAX reference: core/scene_box.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SceneBox:
    """Static scene bounds; `collider_type` selects how rays get near/far."""

    collider_type: str = "sphere"  # sphere | near_far | box
    radius: float = 1.0
    near: Optional[float] = None
    far: Optional[float] = None
    aabb: Optional[Tuple[Tuple[float, float, float], Tuple[float, float, float]]] = None

    def default_aabb(self):
        if self.aabb is not None:
            return self.aabb
        r = float(self.radius)
        return ((-r, -r, -r), (r, r, r))
