"""Grid-tick kernels: plain PyTorch versions (ref), CUDA sources (csrc), their build, wrappers and device dispatch (ops)."""
