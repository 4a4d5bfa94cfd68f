"""app layer of the port (mirrors rawphotoforge_tpu.app)."""
