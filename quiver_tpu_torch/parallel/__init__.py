"""quiver_tpu_torch.parallel."""
