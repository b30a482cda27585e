from .ops import tree_factor, tree_solve  # noqa: F401
from .ref import Forest, tree_factor_ref, tree_solve_ref  # noqa: F401
