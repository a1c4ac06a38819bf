from hyperspace_tpu_torch.plan.rules.filter_index import FilterIndexRule

__all__ = ["FilterIndexRule"]
