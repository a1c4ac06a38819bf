from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.actions.cancel import CancelAction
from hyperspace_tpu_torch.actions.create import CreateAction, CreateActionBase

__all__ = ["Action", "CreateAction", "CreateActionBase", "CancelAction"]
