"""io layer of the port (mirrors rawphotoforge_tpu.io)."""
