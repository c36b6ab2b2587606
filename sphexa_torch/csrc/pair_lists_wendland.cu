// The wendland-c6 form (20 polynomial coefficients) of the list walk K6:
// pair_lists.cu's op instantiations of that form, compiled in an nvcc
// process of their own beside pair_lists.cu's sinc form, which halves the
// build's longest compile. pair_lists.cu's dispatch calls
// list_walk_dispatch_wendland where EngineArgs.ncoef is 20.
#define PAIR_WENDLAND_TU
#include "pair_lists.cu"
