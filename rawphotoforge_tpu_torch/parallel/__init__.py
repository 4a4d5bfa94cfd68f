"""rawphotoforge_tpu_torch.parallel — the multi-device layer on
torch.distributed (``mesh``: the ('batch', 'sp') layout and the sharded
develop and export steps; ``spatial``: row-sharded stencils with halo
exchange)."""
