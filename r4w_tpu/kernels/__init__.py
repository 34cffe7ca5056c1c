"""Hand-written GPU kernels.

`kernels.cuda` builds the CUDA sources beside it with nvcc on first
use and registers them with XLA; the only kernel is the Viterbi decoder
behind `fec.convolutional.viterbi_decode`. Everything else in the
library is plain JAX that XLA compiles.
"""
