"""The plain reference: plain PyTorch and NumPy, independent of the program
under test (it imports nothing of ``fspt_tpu_torch``, ``fspt_tpu`` or JAX)."""
