"""Tensor ops: FFT convolution, image ops, patches and the GMM kernels."""
