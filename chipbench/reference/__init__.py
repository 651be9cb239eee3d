"""Plain NumPy references: the same answers from the raw boolean matrix.

Nothing here imports the program under test or the JAX package.
"""
