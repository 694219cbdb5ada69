"""Device-side ops of the port: the decision steps' pieces as PyTorch
functions on tensors, and the hand-written CUDA kernels behind their table
accesses (ops/sketch_cuda.py with csrc/sketch_kernels.cu for the windowed
sketch, ops/bucket_cuda.py with csrc/bucket_kernels.cu for the token
bucket)."""
