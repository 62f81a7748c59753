"""Device half of the port: tensor containers, plain PyTorch evaluators and
the wrappers of the hand-written CUDA kernels."""
