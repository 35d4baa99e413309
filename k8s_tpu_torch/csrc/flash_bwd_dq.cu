// Flash-attention backward for Hopper, K3: the dq kernels (which also
// write delta) and their entries.  The source is flash_bwd.cuh, built here
// with this half alone so that nvcc compiles the backward's two halves in
// parallel (ops/_build.py).
#define FLASH_BWD_PART 0
#include "flash_bwd.cuh"
