from .ops import expand_degrees, expand_degrees_ref
