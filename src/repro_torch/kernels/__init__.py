"""Block-Shotgun kernels (CUDA for Hopper), their plain versions, oracles and solvers."""
