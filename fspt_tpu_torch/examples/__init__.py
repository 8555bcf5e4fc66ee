"""Examples of the port, run as ``python -m fspt_tpu_torch.examples.<name>``."""
