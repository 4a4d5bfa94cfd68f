"""ops layer of the port (mirrors rawphotoforge_tpu.ops)."""
