"""core layer of the port (mirrors rawphotoforge_tpu.core)."""
