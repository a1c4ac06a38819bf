from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.actions.cancel import CancelAction
from hyperspace_tpu_torch.actions.create import CreateAction, CreateActionBase
from hyperspace_tpu_torch.actions.delete import DeleteAction
from hyperspace_tpu_torch.actions.optimize import OptimizeAction
from hyperspace_tpu_torch.actions.refresh import RefreshAction
from hyperspace_tpu_torch.actions.refresh_incremental import (
    RefreshIncrementalAction)
from hyperspace_tpu_torch.actions.restore import RestoreAction
from hyperspace_tpu_torch.actions.vacuum import VacuumAction

__all__ = ["Action", "CreateAction", "CreateActionBase", "CancelAction",
           "DeleteAction", "OptimizeAction", "RefreshAction",
           "RefreshIncrementalAction", "RestoreAction", "VacuumAction"]
