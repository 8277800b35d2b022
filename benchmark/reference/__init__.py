"""The benchmark's plain reference: one MPC step of the port's algorithm in
plain PyTorch (frozen copies of the port's plain code, the CUDA kernel K1
replaced by its plain version), run in float64 on the instances the check
samples. Imports nothing of the port, of the JAX package or of JAX."""
