"""quiver_tpu_torch.core."""
