"""Device-side ops of the port: the decision step's pieces as PyTorch
functions on tensors, and the hand-written CUDA kernels behind the three
table accesses (ops/sketch_cuda.py, csrc/sketch_kernels.cu)."""
