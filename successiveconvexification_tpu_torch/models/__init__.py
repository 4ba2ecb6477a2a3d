from successiveconvexification_tpu_torch.models.base import Model
from successiveconvexification_tpu_torch.models.pointmass3dof import (
    PointMass3DoFParams,
    pointmass3dof_model,
)
from successiveconvexification_tpu_torch.models.rocket6dof import (
    Rocket6DoFParams,
    rocket6dof_model,
)

__all__ = ["Model", "PointMass3DoFParams", "pointmass3dof_model",
           "Rocket6DoFParams", "rocket6dof_model"]
