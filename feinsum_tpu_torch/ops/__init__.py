"""Device-side code: layouts, the DG row planner and the CUDA kernels."""
