from successiveconvexification_tpu_torch.models.base import Model
from successiveconvexification_tpu_torch.models.rocket6dof import (
    Rocket6DoFParams,
    rocket6dof_model,
)

__all__ = ["Model", "Rocket6DoFParams", "rocket6dof_model"]
