"""Matrix primitives and the kernels' cost model."""
