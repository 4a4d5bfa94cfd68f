"""engine layer of the port (mirrors rawphotoforge_tpu.engine)."""
