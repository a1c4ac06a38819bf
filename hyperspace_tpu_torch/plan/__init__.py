from hyperspace_tpu_torch.plan.schema import Field, Schema
from hyperspace_tpu_torch.plan.expr import (
    Add, And, Column, Div, EqualTo, Expression, GreaterThan, GreaterThanOrEqual,
    In, IsNotNull, IsNull, LessThan, LessThanOrEqual, Literal, Mul, Not,
    NotEqualTo, Or, Sub,
)
from hyperspace_tpu_torch.plan.nodes import (
    Aggregate, AggSpec, BucketSpec, Filter, Join, Limit, LogicalPlan,
    Project, Scan, Sort, Union,
)

__all__ = [
    "Field", "Schema",
    "Add", "And", "Column", "Div", "EqualTo", "Expression", "GreaterThan",
    "GreaterThanOrEqual", "In", "IsNotNull", "IsNull", "LessThan",
    "LessThanOrEqual", "Literal", "Mul", "Not", "NotEqualTo", "Or", "Sub",
    "Aggregate", "AggSpec", "BucketSpec", "Filter", "Join", "Limit",
    "LogicalPlan", "Project", "Scan", "Sort", "Union",
]
