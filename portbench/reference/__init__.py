"""The benchmark's plain reference: NumPy and the standard library only.

Nothing here imports the program under test, JAX or the JAX package.
"""
