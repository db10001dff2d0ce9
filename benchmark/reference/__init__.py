"""The plain reference of the benchmark's cells and the scene loader both
sides read. Imports nothing of the program or of JAX."""
