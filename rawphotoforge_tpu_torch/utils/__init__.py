"""utils layer of the port (mirrors rawphotoforge_tpu.utils)."""
