from hyperspace_tpu_torch.plan.schema import Field, Schema
from hyperspace_tpu_torch.plan.expr import (
    Add, And, Column, Div, EqualTo, Expression, GreaterThan, GreaterThanOrEqual,
    In, IsNotNull, IsNull, LessThan, LessThanOrEqual, Literal, Mul, Not,
    NotEqualTo, Or, Sub,
)
from hyperspace_tpu_torch.plan.nodes import (
    BucketSpec, Filter, Join, LogicalPlan, Project, Scan, Union,
)

__all__ = [
    "Field", "Schema",
    "Add", "And", "Column", "Div", "EqualTo", "Expression", "GreaterThan",
    "GreaterThanOrEqual", "In", "IsNotNull", "IsNull", "LessThan",
    "LessThanOrEqual", "Literal", "Mul", "Not", "NotEqualTo", "Or", "Sub",
    "BucketSpec", "Filter", "Join", "LogicalPlan", "Project", "Scan",
    "Union",
]
