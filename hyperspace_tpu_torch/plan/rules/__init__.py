from hyperspace_tpu_torch.plan.rules.filter_index import FilterIndexRule
from hyperspace_tpu_torch.plan.rules.join_index import JoinIndexRule

__all__ = ["FilterIndexRule", "JoinIndexRule"]
