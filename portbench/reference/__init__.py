"""Plain NumPy references of what the timed paths produce.  Nothing here
imports the program (``repro_torch``), JAX or the JAX package."""
