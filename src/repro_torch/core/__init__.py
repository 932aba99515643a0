"""Treewidth core: bitsets, graphs, host planning, the wavefront engine."""
