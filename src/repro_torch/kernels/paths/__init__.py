from .ops import paths_matrix, paths_matrix_ref
