"""kernels layer of the port (mirrors rawphotoforge_tpu.kernels)."""
