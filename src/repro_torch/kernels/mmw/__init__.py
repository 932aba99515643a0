from .ops import mmw_bounds, mmw_bounds_ref
