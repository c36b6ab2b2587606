// The wendland-c6 form (20 polynomial coefficients) of the streaming
// engine K1: pair_engine.cu's op instantiations of that form, compiled in
// an nvcc process of their own beside pair_engine.cu's sinc form, which
// halves the build's longest compile. pair_engine.cu's dispatch calls
// pair_engine_dispatch_wendland where EngineArgs.ncoef is 20.
#define PAIR_WENDLAND_TU
#include "pair_engine.cu"
