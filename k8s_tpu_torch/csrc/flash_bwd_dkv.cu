// Flash-attention backward for Hopper, K4: the dk/dv kernels and their
// entries.  The source is flash_bwd.cuh, built here with this half alone
// so that nvcc compiles the backward's two halves in parallel
// (ops/_build.py).
#define FLASH_BWD_PART 1
#include "flash_bwd.cuh"
